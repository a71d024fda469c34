"""AnnData adapters of the port: extract inputs from and write results back
to AnnData.

The port's own copy of :mod:`flashdeconv_tpu.io.loader` (the code is
unchanged). Pure host code; anndata / pandas are optional dependencies,
pandas imported lazily. Parity targets: reference
``flashdeconv/io/loader.py`` (spatial extraction :15-70, reference
aggregation :73-140, gene alignment :143-194, write-back :197-258,
prepare_data :261-311).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
from scipy import sparse

ArrayLike = Union[np.ndarray, sparse.spmatrix]


def load_spatial_data(
    adata: Any,
    layer: Optional[str] = None,
    coord_key: str = "spatial",
) -> Tuple[ArrayLike, np.ndarray, np.ndarray]:
    """Extract (counts, coordinates, gene names) from a spatial AnnData.

    Coordinate lookup order: ``obsm[coord_key]`` -> ``obsm["X_spatial"]`` ->
    ``obs["x"]/["y"]`` -> ``obs["array_row"]/["array_col"]``.
    """
    Y = adata.layers[layer] if layer is not None else adata.X

    if coord_key in adata.obsm:
        coords = np.array(adata.obsm[coord_key])
    elif "X_spatial" in adata.obsm:
        coords = np.array(adata.obsm["X_spatial"])
    elif "x" in adata.obs and "y" in adata.obs:
        coords = np.column_stack([adata.obs["x"], adata.obs["y"]])
    elif "array_row" in adata.obs and "array_col" in adata.obs:
        coords = np.column_stack([adata.obs["array_row"], adata.obs["array_col"]])
    else:
        raise ValueError(
            f"Could not find spatial coordinates. "
            f"Expected key '{coord_key}' in adata.obsm or 'x'/'y' in adata.obs"
        )

    return Y, coords, np.array(adata.var_names)


def load_reference(
    adata_ref: Any,
    cell_type_key: str = "cell_type",
    layer: Optional[str] = None,
    method: str = "mean",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aggregate a single-cell AnnData into a (K x G) signature matrix.

    Cells are grouped by ``obs[cell_type_key]`` and aggregated per gene by
    mean or sum; sparse expression is aggregated without densifying.
    """
    expr = adata_ref.layers[layer] if layer is not None else adata_ref.X

    if cell_type_key not in adata_ref.obs:
        raise ValueError(
            f"Cell type key '{cell_type_key}' not found in adata_ref.obs"
        )
    if method not in ("mean", "sum"):
        raise ValueError(f"Unknown aggregation method: {method}")

    labels = np.array(adata_ref.obs[cell_type_key])
    unique_types = np.unique(labels)
    is_sparse = sparse.issparse(expr)

    X = np.zeros((unique_types.size, expr.shape[1]), dtype=np.float64)
    for i, ct in enumerate(unique_types):
        subset = expr[labels == ct]
        if method == "mean":
            agg = subset.mean(axis=0)
        else:
            agg = subset.sum(axis=0)
        X[i] = np.asarray(agg).ravel() if is_sparse else np.asarray(agg)

    return X, unique_types, np.array(adata_ref.var_names)


def align_genes(
    Y: ArrayLike,
    X: np.ndarray,
    genes_spatial: np.ndarray,
    genes_ref: np.ndarray,
) -> Tuple[ArrayLike, np.ndarray, np.ndarray]:
    """Subset Y and X to their shared gene set (first occurrence wins).

    Returns (Y_aligned, X_aligned, common_genes); raises if the intersection
    is empty.
    """
    common = np.intersect1d(genes_spatial, genes_ref)
    if common.size == 0:
        raise ValueError("No common genes found between spatial data and reference")

    def first_occurrence_index(names):
        lookup = {}
        for i, g in enumerate(names):
            lookup.setdefault(g, i)
        return lookup

    st_lookup = first_occurrence_index(genes_spatial)
    ref_lookup = first_occurrence_index(genes_ref)
    st_idx = np.array([st_lookup[g] for g in common])
    ref_idx = np.array([ref_lookup[g] for g in common])

    return Y[:, st_idx], X[:, ref_idx], common


def result_to_anndata(
    beta: np.ndarray,
    adata: Any,
    cell_type_names: Optional[np.ndarray] = None,
    key_added: str = "flashdeconv",
) -> Any:
    """Write proportions into ``adata.obsm[key_added]`` (+ dominant type).

    Stores a pandas DataFrame of proportions in ``obsm`` and a categorical
    ``obs[f"{key_added}_dominant"]`` column; per-type obs columns are not
    materialized (they would duplicate the obsm matrix).
    """
    import pandas as pd

    if beta.ndim != 2:
        raise ValueError(f"beta must be 2D, got shape {beta.shape}")
    if beta.shape[0] != adata.n_obs:
        raise ValueError(
            f"beta rows must match adata.n_obs, got beta.shape[0]={beta.shape[0]} "
            f"and adata.n_obs={adata.n_obs}"
        )

    if cell_type_names is not None:
        columns = np.asarray(cell_type_names)
    else:
        columns = np.array([f"CellType_{i}" for i in range(beta.shape[1])])
    if len(columns) != beta.shape[1]:
        raise ValueError(
            f"Length of cell_type_names ({len(columns)}) must match "
            f"beta.shape[1] ({beta.shape[1]})"
        )

    adata.obsm[key_added] = pd.DataFrame(
        beta, index=adata.obs_names, columns=columns
    )
    dominant = columns[np.argmax(beta, axis=1)]
    adata.obs[f"{key_added}_dominant"] = pd.Categorical(
        dominant, categories=columns
    )
    return adata


def prepare_data(
    adata_st: Any,
    adata_ref: Any,
    cell_type_key: str = "cell_type",
    spatial_coord_key: str = "spatial",
    layer_st: Optional[str] = None,
    layer_ref: Optional[str] = None,
) -> Tuple[ArrayLike, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Load, aggregate, and gene-align both AnnData inputs in one call.

    Returns (Y, X, coords, cell_type_names, common_gene_names).
    """
    Y, coords, genes_st = load_spatial_data(
        adata_st, layer=layer_st, coord_key=spatial_coord_key
    )
    X, cell_type_names, genes_ref = load_reference(
        adata_ref, cell_type_key=cell_type_key, layer=layer_ref
    )
    Y, X, gene_names = align_genes(Y, X, genes_st, genes_ref)
    return Y, X, coords, cell_type_names, gene_names
