"""Plotting for deconvolution results (matplotlib is an optional dep).

The port's own copy of :mod:`flashdeconv_tpu.pl._plots`, unchanged but for
the module paths: the reference package has no plotting module (its
tutorials build ad-hoc matplotlib figures), and this module packages those
recurring figures behind a scanpy-style ``fdt.pl`` namespace so the
one-call workflow (``fdt.tl.deconvolve`` → ``adata.obsm["flashdeconv"]``)
has a matching one-call visualization layer.

Conventions follow scanpy's plotting API: every function takes the AnnData
written by :func:`flashdeconv_tpu_torch.tl.deconvolve` (or an explicit
``(coords, values)`` pair for the array-level workflow), draws onto a
provided ``ax`` or a fresh figure, and returns the Axes. Everything here is
host numpy and matplotlib: the fit's outputs are host arrays.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np


def _require_mpl():
    try:
        import matplotlib
        import matplotlib.pyplot as plt  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "flashdeconv_tpu_torch.pl requires matplotlib. "
            "Install it with: pip install 'flashdeconv-tpu[plot]' "
            "(or pip install matplotlib)"
        ) from e
    return matplotlib


def _get_coords(adata: Any, spatial_key: str) -> np.ndarray:
    from flashdeconv_tpu_torch.io.loader import load_spatial_data

    _, coords, _ = load_spatial_data(adata, coord_key=spatial_key)
    # Same float cast as the array path: object-dtype obs columns (e.g.
    # string x/y) must fail here with a clear conversion error, not deep
    # inside matplotlib.
    return np.asarray(coords, dtype=float)


def _check_names(names, values) -> None:
    if len(names) != values.shape[1]:
        raise ValueError(
            f"cell_type_names has {len(names)} entries but proportions "
            f"has {values.shape[1]} columns"
        )


def _get_props(adata: Any, key: str):
    if key not in adata.obsm:
        raise KeyError(
            f"adata.obsm[{key!r}] not found — run "
            f"flashdeconv_tpu_torch.tl.deconvolve(..., key_added={key!r}) first"
        )
    df = adata.obsm[key]
    values = np.asarray(df)
    names = (
        [str(c) for c in df.columns]
        if hasattr(df, "columns")
        else [f"type_{i}" for i in range(values.shape[1])]
    )
    return values, names


def _resolve_inputs(adata, key, spatial_key, coords, proportions,
                    cell_type_names):
    """(coords, values, names) from either an AnnData or explicit arrays."""
    if adata is not None:
        values, names = _get_props(adata, key)
        return _get_coords(adata, spatial_key), values, names
    if coords is None or proportions is None:
        raise ValueError(
            "pass an AnnData (the tl.deconvolve workflow) or both "
            "coords= and proportions= (the array-level workflow)"
        )
    values = np.asarray(proportions)
    names = (
        [str(c) for c in cell_type_names]
        if cell_type_names is not None
        else [f"type_{i}" for i in range(values.shape[1])]
    )
    _check_names(names, values)
    return np.asarray(coords, dtype=float), values, names


def spatial(
    adata: Any = None,
    color: str = "dominant",
    key: str = "flashdeconv",
    spatial_key: str = "spatial",
    ax: Any = None,
    spot_size: Optional[float] = None,
    cmap: str = "viridis",
    title: Optional[str] = None,
    colorbar: bool = True,
    legend: bool = True,
    coords: Optional[np.ndarray] = None,
    proportions: Optional[np.ndarray] = None,
    cell_type_names: Optional[Sequence[str]] = None,
):
    """Spatial scatter of the deconvolution result.

    Parameters
    ----------
    adata : AnnData with ``obsm[key]`` (written by ``tl.deconvolve``);
        or None to plot array-level results — pass ``coords`` and
        ``proportions`` (e.g. ``FlashDeconv.fit_transform``'s output)
        plus optional ``cell_type_names``.
    color : ``"dominant"`` (categorical dominant-type map — the
        ``obs[f"{key}_dominant"]`` column, or the proportions argmax on
        the array path) or one cell-type name (that type's proportion as
        a continuous map).
    key, spatial_key : result / coordinate keys (AnnData path).
    ax : existing matplotlib Axes to draw on (a fresh figure otherwise).
    spot_size : marker area in points²; auto-scaled from spot count when
        None.
    cmap : colormap for continuous proportions.
    colorbar / legend : toggles for the continuous / categorical scale.

    Returns the matplotlib Axes.
    """
    _require_mpl()
    import matplotlib.pyplot as plt

    xy, values, names = _resolve_inputs(
        adata, key, spatial_key, coords, proportions, cell_type_names
    )
    n = xy.shape[0]
    if spot_size is None:
        spot_size = float(np.clip(2e5 / max(n, 1), 0.5, 40.0))
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    coords = xy

    if color == "dominant":
        if adata is not None:
            col = f"{key}_dominant"
            if col not in adata.obs:
                raise KeyError(
                    f"adata.obs[{col!r}] not found — run tl.deconvolve "
                    f"first"
                )
            labels = np.asarray(adata.obs[col].astype(str))
        else:
            labels = np.asarray(
                [names[i] for i in values.argmax(axis=1)]
            )
        cats = sorted(set(labels))
        cmap_cat = plt.get_cmap("tab20")
        for i, cat in enumerate(cats):
            m = labels == cat
            ax.scatter(
                coords[m, 0], coords[m, 1], s=spot_size,
                color=cmap_cat(i % 20), label=cat, linewidths=0,
            )
        if legend:
            ax.legend(
                markerscale=max(1.0, 8.0 / np.sqrt(spot_size)),
                fontsize=8, loc="center left", bbox_to_anchor=(1.0, 0.5),
            )
        ax.set_title(title or f"{key}: dominant cell type")
    else:
        if color not in names:
            raise KeyError(
                f"{color!r} is not a cell type of the result; "
                f"available: {names}"
            )
        v = values[:, names.index(color)]
        sc = ax.scatter(
            coords[:, 0], coords[:, 1], c=v, s=spot_size, cmap=cmap,
            vmin=0.0, vmax=max(float(v.max()), 1e-9), linewidths=0,
        )
        if colorbar:
            plt.colorbar(sc, ax=ax, label=f"{color} proportion")
        ax.set_title(title or f"{key}: {color}")

    ax.set_aspect("equal")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    return ax


def composition(
    adata: Any = None,
    key: str = "flashdeconv",
    ax: Any = None,
    sort: bool = True,
    color: Optional[Sequence] = None,
    proportions: Optional[np.ndarray] = None,
    cell_type_names: Optional[Sequence[str]] = None,
):
    """Mean cell-type composition bar chart (mean proportion per type).

    Accepts the ``tl.deconvolve`` AnnData or, on the array-level
    workflow, ``proportions=`` (+ optional ``cell_type_names=``).
    Returns the matplotlib Axes.
    """
    _require_mpl()
    import matplotlib.pyplot as plt

    if adata is not None:
        values, names = _get_props(adata, key)
    elif proportions is not None:
        values = np.asarray(proportions)
        names = (
            [str(c) for c in cell_type_names]
            if cell_type_names is not None
            else [f"type_{i}" for i in range(values.shape[1])]
        )
        _check_names(names, values)
    else:
        raise ValueError("pass an AnnData or proportions=")
    means = values.mean(axis=0)
    order = np.argsort(means)[::-1] if sort else np.arange(means.size)
    if ax is None:
        _, ax = plt.subplots(figsize=(max(4, 0.45 * len(names)), 4))
    # A per-type color sequence follows its bar through the sort; a single
    # color (str, or anything not matching the type count) passes through.
    bar_color = color
    if (
        color is not None
        and not isinstance(color, str)
        and hasattr(color, "__len__")
        and len(color) == means.size
    ):
        bar_color = [color[i] for i in order]
    ax.bar(
        np.arange(means.size), means[order],
        color=bar_color, edgecolor="none",
    )
    ax.set_xticks(np.arange(means.size))
    ax.set_xticklabels([names[i] for i in order], rotation=60, ha="right")
    ax.set_ylabel("mean proportion")
    ax.set_title(f"{key}: composition")
    return ax


def lambda_path(
    results: Sequence[dict],
    ax: Any = None,
    metric: str = "final_objective",
):
    """Diagnostics across a λ grid from :meth:`FlashDeconv.fit_lambda_path`.

    Plots the chosen ``metric`` (a key of each result's ``info`` dict —
    ``"final_objective"`` or ``"n_iterations"``) against λ on a log x-axis,
    annotated with per-λ sparsity (fraction of abundances at exactly 0).

    Returns the matplotlib Axes.
    """
    _require_mpl()
    import matplotlib.pyplot as plt

    lams = [r["lambda"] for r in results]
    vals = [r["info"][metric] for r in results]
    spars = [float(np.mean(np.asarray(r["beta"]) == 0.0)) for r in results]
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    ax.plot(lams, vals, marker="o")
    ax.set_xscale("log")
    ax.set_xlabel("lambda_spatial")
    ax.set_ylabel(metric)
    ax2 = ax.twinx()
    ax2.plot(lams, spars, marker="s", linestyle="--", color="tab:gray")
    ax2.set_ylabel("zero fraction of beta", color="tab:gray")
    ax.set_title("lambda path")
    return ax
