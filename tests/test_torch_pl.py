"""The port's plotting layer against the JAX package's, on the Agg backend.

``flashdeconv_tpu_torch.pl`` is the port's copy of ``flashdeconv_tpu.pl``.
A fit of the port (``tl.deconvolve`` on the CPU, on tests/fake_anndata.py's
stand-in) is drawn by both packages' ``spatial``, ``composition`` and
``lambda_path``; the figures must hold the same artists with the same data:
scatter offsets, colours and value arrays, bar geometry and colours, line
data, legend and axis texts, scales, and the number of axes (colour bars).
"""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import flashdeconv_tpu as fd  # noqa: E402
import flashdeconv_tpu_torch as fdt  # noqa: E402
from fake_anndata import make_reference_adata, make_spatial_adata  # noqa: E402
from flashdeconv_tpu_torch.utils.graph import grid_coords  # noqa: E402


@pytest.fixture(scope="module")
def fitted_adata():
    rng = np.random.RandomState(0)
    N, G, K = 150, 400, 4
    genes = [f"g{i}" for i in range(G)]
    X = rng.gamma(2.0, 1.0, size=(K, G)) * (rng.rand(K, G) < 0.3)
    props = rng.dirichlet(np.ones(K), size=N)
    mean = props @ X
    mean = mean / (mean.sum(1, keepdims=True) + 1e-12) * 1200
    st = make_spatial_adata(rng.poisson(mean).astype(float), grid_coords(N),
                            gene_names=genes)
    counts, labels = [], []
    for k in range(K):
        lam = X[k] / (X[k].sum() + 1e-12) * 1200
        counts.append(rng.poisson(lam, size=(12, G)))
        labels += [f"type_{k}"] * 12
    ref = make_reference_adata(np.vstack(counts).astype(float), labels,
                               gene_names=genes)
    fdt.tl.deconvolve(st, ref, sketch_dim=64, n_hvg=150,
                      n_markers_per_type=10, device="cpu")
    return st


def _content(ax):
    """What an Axes draws, as comparable data."""
    fig = ax.figure
    legend = ax.get_legend()
    return {
        "collections": [
            (np.asarray(c.get_offsets()), np.asarray(c.get_facecolors()),
             None if c.get_array() is None else np.asarray(c.get_array()),
             np.asarray(c.get_sizes()))
            for c in ax.collections],
        "patches": [(p.get_x(), p.get_width(), p.get_height(),
                     p.get_facecolor()) for p in ax.patches],
        "lines": [(np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()))
                  for ln in ax.get_lines()],
        "texts": (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                  [t.get_text() for t in ax.get_xticklabels()]),
        "legend": None if legend is None else [
            t.get_text() for t in legend.get_texts()],
        "scales": (ax.get_xscale(), ax.get_yscale()),
        "n_axes": len(fig.axes),
        "twin_lines": [[np.asarray(ln.get_ydata()) for ln in a.get_lines()]
                       for a in fig.axes if a is not ax],
    }


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _both(fn_name, *args, **kwargs):
    out = []
    for pkg in (fd, fdt):
        out.append(_content(getattr(pkg.pl, fn_name)(*args, **kwargs)))
        plt.close("all")
    return out


@pytest.mark.parametrize("kwargs", [
    {"color": "dominant"}, {"color": "type_1"},
    {"color": "type_0", "colorbar": False, "spot_size": 12.0},
])
def test_spatial_matches_jax(fitted_adata, kwargs):
    ref, got = _both("spatial", fitted_adata, **kwargs)
    _same(ref, got)
    assert sum(len(c[0]) for c in got["collections"]) == 150


def test_spatial_array_level_matches_jax(fitted_adata):
    P = np.asarray(fitted_adata.obsm["flashdeconv"])
    names = list(fitted_adata.obsm["flashdeconv"].columns)
    coords = np.asarray(fitted_adata.obsm["spatial"], dtype=float)
    for color in ("dominant", names[2]):
        ref, got = _both("spatial", coords=coords, proportions=P,
                         cell_type_names=names, color=color)
        _same(ref, got)


@pytest.mark.parametrize("kwargs", [{}, {"sort": False},
                                    {"color": ["red", "green", "blue",
                                               "orange"]}])
def test_composition_matches_jax(fitted_adata, kwargs):
    ref, got = _both("composition", fitted_adata, **kwargs)
    _same(ref, got)
    P = np.asarray(fitted_adata.obsm["flashdeconv"])
    np.testing.assert_allclose(sorted(p[2] for p in got["patches"]),
                               sorted(P.mean(axis=0)), atol=1e-12)


def test_lambda_path_matches_jax():
    rng = np.random.RandomState(1)
    results = [
        {"lambda": lam, "beta": np.maximum(rng.randn(50, 4) - lam, 0.0),
         "info": {"final_objective": 100.0 / (1 + lam), "n_iterations": 5}}
        for lam in (0.01, 0.1, 1.0)
    ]
    for metric in ("final_objective", "n_iterations"):
        ref, got = _both("lambda_path", results, metric=metric)
        _same(ref, got)
    assert got["scales"][0] == "log"


def test_errors_match_jax(fitted_adata):
    for pkg in (fd, fdt):
        with pytest.raises(KeyError, match="not a cell type"):
            pkg.pl.spatial(fitted_adata, color="no_such_type")
        with pytest.raises(KeyError, match="obsm"):
            pkg.pl.composition(fitted_adata, key="missing_key")
        with pytest.raises(ValueError, match="coords"):
            pkg.pl.spatial()
    plt.close("all")
