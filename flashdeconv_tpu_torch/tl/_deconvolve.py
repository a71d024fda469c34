"""Scanpy-style one-call deconvolution tool of the port.

Counterpart of :func:`flashdeconv_tpu.tl.deconvolve` (reference
``flashdeconv/tl/_deconvolve.py:6-174``): the same keyword surface plus
``device``, the same AnnData output contract (``obsm[key_added]``
DataFrame, ``obs[f"{key_added}_dominant"]`` categorical,
``uns[f"{key_added}_params"]`` run record) and the same ``copy=True``
semantics.
"""

from __future__ import annotations

from typing import Any, Optional, Union


def deconvolve(
    adata_st: Any,
    adata_ref: Any,
    cell_type_key: str = "cell_type",
    *,
    sketch_dim: int = 512,
    lambda_spatial: Union[float, str] = "auto",
    rho_sparsity: float = 0.01,
    n_hvg: int = 2000,
    n_markers_per_type: int = 50,
    spatial_method: str = "knn",
    k_neighbors: int = 6,
    radius: Optional[float] = None,
    preprocess: str = "log_cpm",
    layer_st: Optional[str] = None,
    layer_ref: Optional[str] = None,
    spatial_key: str = "spatial",
    key_added: str = "flashdeconv",
    random_state: int = 0,
    copy: bool = False,
    max_iter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
    mesh: Any = None,
    n_shards: Optional[int] = None,
    fetch_dtype: Optional[str] = None,
    device="cuda",
) -> Optional[Any]:
    """Estimate per-spot cell-type proportions and store them in ``adata_st``.

    Parameters mirror :class:`flashdeconv_tpu_torch.FlashDeconv`, which
    fits on ``device`` ("cuda" by default; "cpu" runs the plain PyTorch
    sweeps). With ``copy=False`` (default) the AnnData is modified in place
    and None is returned; with ``copy=True`` a modified copy is returned.
    ``mesh`` / ``n_shards`` route the solve through the spot-sharded path;
    ``fetch_dtype="float16"`` casts the proportions on the card before
    they are fetched (values in [0, 1] quantize at ~5e-4).

    Adds to the AnnData:

    - ``.obsm[key_added]`` — (n_spots x n_types) proportions DataFrame
    - ``.obs[f"{key_added}_dominant"]`` — categorical dominant type
    - ``.uns[f"{key_added}_params"]`` — run parameters + convergence record
    """
    from flashdeconv_tpu_torch.core.deconv import FlashDeconv
    from flashdeconv_tpu_torch.io import prepare_data, result_to_anndata

    adata = adata_st.copy() if copy else adata_st

    Y, X, coords, cell_type_names, _ = prepare_data(
        adata,
        adata_ref,
        cell_type_key=cell_type_key,
        layer_st=layer_st,
        layer_ref=layer_ref,
        spatial_coord_key=spatial_key,
    )

    model = FlashDeconv(
        sketch_dim=sketch_dim,
        lambda_spatial=lambda_spatial,
        rho_sparsity=rho_sparsity,
        n_hvg=n_hvg,
        n_markers_per_type=n_markers_per_type,
        spatial_method=spatial_method,
        k_neighbors=k_neighbors,
        radius=radius,
        preprocess=preprocess,
        random_state=random_state,
        max_iter=max_iter,
        tol=tol,
        verbose=verbose,
        mesh=mesh,
        n_shards=n_shards,
        fetch_dtype=fetch_dtype,
        device=device,
    )
    proportions = model.fit_transform(Y, X, coords,
                                      cell_type_names=cell_type_names)

    result_to_anndata(proportions, adata, cell_type_names, key_added=key_added)

    adata.uns[f"{key_added}_params"] = {
        "sketch_dim": sketch_dim,
        "lambda_spatial": float(model.lambda_used_),
        "rho_sparsity": rho_sparsity,
        "n_hvg": n_hvg,
        "n_markers_per_type": n_markers_per_type,
        "spatial_method": spatial_method,
        "k_neighbors": k_neighbors,
        "radius": radius,
        "preprocess": preprocess,
        "n_genes_used": len(model.gene_idx_),
        "n_cell_types": len(cell_type_names),
        "cell_type_names": list(cell_type_names),
        "random_state": random_state,
        "converged": model.info_.get("converged", False),
        "n_iterations": model.info_.get("n_iterations", 0),
    }

    return adata if copy else None
