"""The port's AnnData layer (``io`` copies and ``tl.deconvolve``) against
the JAX package's, on the CPU, through tests/fake_anndata.py (anndata is
not installed here; the layer touches only the duck-typed surface).

The ``io`` functions are copies, held bit for bit on the same inputs.
``tl.deconvolve`` runs ``FlashDeconv`` underneath: the same genes, names
and parameters, and proportions within 1e-5 of the JAX one (two f32
solves, tests/test_torch_solver.py's bound), under the in-place and
``copy=True`` contracts, ``key_added`` and ``fetch_dtype``.
"""

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse

import flashdeconv_tpu
import flashdeconv_tpu_torch
from conftest import make_synthetic
from fake_anndata import FakeAnnData, make_reference_adata, make_spatial_adata
from flashdeconv_tpu import io as jio
from flashdeconv_tpu_torch import io as tio

torch.set_num_threads(2)

SMALL = dict(sketch_dim=128, n_hvg=200, n_markers_per_type=10)


def _equal(a, b):
    if sparse.issparse(a):
        assert sparse.issparse(b) and a.format == b.format
        assert (a != b).nnz == 0
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert type(a) is type(b)
    np.testing.assert_array_equal(a, b)
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _spatial(obsm_key="spatial", n=30, g=40, seed=0):
    rng = np.random.RandomState(seed)
    Y = rng.poisson(1.0, size=(n, g)).astype(float)
    ad = FakeAnnData(Y)
    if obsm_key == "obs_xy":
        ad.obs["x"], ad.obs["y"] = rng.rand(n), rng.rand(n)
    elif obsm_key == "array":
        ad.obs["array_row"] = rng.randint(0, 9, n)
        ad.obs["array_col"] = rng.randint(0, 9, n)
    else:
        ad.obsm[obsm_key] = rng.rand(n, 2)
    ad.layers["counts"] = Y * 2
    return ad


@pytest.mark.parametrize("case", ["spatial", "X_spatial", "obs_xy", "array",
                                  "layer"])
def test_load_spatial_data_is_bitwise_jax(case):
    ad = _spatial("spatial" if case == "layer" else case)
    kw = {"layer": "counts"} if case == "layer" else {}
    _equal(tio.load_spatial_data(ad, **kw), jio.load_spatial_data(ad, **kw))


def test_missing_coordinates_raise_as_jax():
    ad = FakeAnnData(np.zeros((4, 3)))
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="spatial coordinates"):
            mod.load_spatial_data(ad)


@pytest.mark.parametrize("sparse_X", [False, True])
@pytest.mark.parametrize("method", ["mean", "sum"])
def test_load_reference_is_bitwise_jax(method, sparse_X):
    rng = np.random.RandomState(0)
    counts = rng.poisson(2.0, size=(40, 120)).astype(float)
    if sparse_X:
        counts = sparse.csr_matrix(counts)
    labels = np.repeat([f"type_{k}" for k in (3, 0, 4, 1, 2)], 8)
    ad = make_reference_adata(counts, labels)
    _equal(tio.load_reference(ad, method=method),
           jio.load_reference(ad, method=method))
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="not found"):
            mod.load_reference(ad, cell_type_key="nope")
        with pytest.raises(ValueError, match="Unknown aggregation"):
            mod.load_reference(ad, method="median")


def test_align_genes_is_bitwise_jax():
    rng = np.random.RandomState(2)
    Y = sparse.csr_matrix(rng.poisson(1.0, (12, 8)).astype(float))
    X = rng.rand(3, 6)
    genes_st = np.array(["a", "b", "c", "a", "d", "e", "f", "g"])
    genes_ref = np.array(["g", "c", "z", "a", "a", "q"])
    _equal(tio.align_genes(Y, X, genes_st, genes_ref),
           jio.align_genes(Y, X, genes_st, genes_ref))
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="No common genes"):
            mod.align_genes(Y, X, genes_st, np.array(["x"]))


@pytest.mark.parametrize("names", [None, np.array(["A", "B", "C"])])
def test_result_to_anndata_is_jax(names):
    beta = np.random.RandomState(3).dirichlet(np.ones(3), size=10)
    ours, theirs = FakeAnnData(np.zeros((10, 4))), FakeAnnData(
        np.zeros((10, 4)))
    tio.result_to_anndata(beta, ours, names, key_added="k")
    jio.result_to_anndata(beta, theirs, names, key_added="k")
    pd.testing.assert_frame_equal(ours.obsm["k"], theirs.obsm["k"])
    pd.testing.assert_series_equal(ours.obs["k_dominant"],
                                   theirs.obs["k_dominant"])
    for bad in (beta[:4], beta[:, :2] if names is not None else beta[0]):
        for mod, ad in ((tio, ours), (jio, theirs)):
            with pytest.raises(ValueError):
                mod.result_to_anndata(bad, ad, names)


def test_prepare_data_is_bitwise_jax():
    rng = np.random.RandomState(0)
    genes = [f"g{i}" for i in range(50)]
    Y = rng.poisson(1.0, size=(20, 50)).astype(float)
    st = make_spatial_adata(Y, rng.rand(20, 2), gene_names=genes)
    ref = make_reference_adata(rng.poisson(2.0, size=(30, 40)).astype(float),
                               ["t0"] * 15 + ["t1"] * 15,
                               gene_names=genes[5:45])
    _equal(tio.prepare_data(st, ref), jio.prepare_data(st, ref))


# -- tl.deconvolve ------------------------------------------------------------

def _pair():
    """tests/test_io.py's pair: 150 spots x 300 genes, 5 types, reference
    cells drawn around each signature row."""
    Y, X, coords, props = make_synthetic(n_spots=150, n_genes=300,
                                         n_types=5, seed=0)
    genes = [f"g{i}" for i in range(Y.shape[1])]
    st = make_spatial_adata(Y, coords, gene_names=genes)
    rng = np.random.RandomState(1)
    counts, labels = [], []
    for k in range(X.shape[0]):
        lam = X[k] / (X[k].sum() + 1e-12) * 1500
        counts.append(rng.poisson(lam, size=(12, X.shape[1])))
        labels += [f"type_{k}"] * 12
    ref = make_reference_adata(np.vstack(counts).astype(float), labels,
                               gene_names=genes)
    return st, ref, props


def _deconvolve(pkg, st, ref, **kw):
    if pkg is flashdeconv_tpu_torch:
        kw["device"] = "cpu"
    return pkg.tl.deconvolve(st, ref, **SMALL, **kw)


def _same_record(ours, theirs, key="flashdeconv"):
    P, R = ours.obsm[key], theirs.obsm[key]
    assert list(P.columns) == list(R.columns)
    assert list(P.index) == list(R.index)
    np.testing.assert_allclose(P.to_numpy(), R.to_numpy(), atol=1e-5)
    np.testing.assert_allclose(P.sum(axis=1), 1.0, atol=1e-6)
    assert ours.obs[f"{key}_dominant"].dtype.name == "category"
    assert (list(ours.obs[f"{key}_dominant"].cat.categories)
            == list(theirs.obs[f"{key}_dominant"].cat.categories))
    assert ours.uns[f"{key}_params"] == theirs.uns[f"{key}_params"]


def test_deconvolve_in_place_matches_jax():
    st, ref, props = _pair()
    st_j = st.copy()
    assert _deconvolve(flashdeconv_tpu_torch, st, ref) is None
    assert _deconvolve(flashdeconv_tpu, st_j, ref) is None
    _same_record(st, st_j)
    assert st.obsm["flashdeconv"].shape == (150, 5)
    params = st.uns["flashdeconv_params"]
    assert params["sketch_dim"] == 128 and params["n_hvg"] == 200
    assert params["cell_type_names"] == [f"type_{k}" for k in range(5)]
    P = np.asarray(st.obsm["flashdeconv"])
    assert np.corrcoef(P.ravel(), props.ravel())[0, 1] > 0.3


def test_deconvolve_copy_and_key_added_match_jax():
    st, ref, _ = _pair()
    out = _deconvolve(flashdeconv_tpu_torch, st, ref, copy=True,
                      key_added="mine")
    out_j = _deconvolve(flashdeconv_tpu, st, ref, copy=True,
                        key_added="mine")
    assert out is not st
    assert "mine" not in st.obsm and "mine_dominant" not in st.obs
    _same_record(out, out_j, key="mine")
    assert "mine_params" in out.uns


def test_deconvolve_forwards_fetch_dtype():
    """``fetch_dtype`` reaches ``FlashDeconv`` (an invalid value raises its
    ValueError); on the CPU the fit takes the host path, which ignores it,
    as the JAX one does there."""
    st, ref, _ = _pair()
    st_j = st.copy()
    _deconvolve(flashdeconv_tpu_torch, st, ref, fetch_dtype="float16")
    _deconvolve(flashdeconv_tpu, st_j, ref, fetch_dtype="float16")
    _same_record(st, st_j)
    for pkg in (flashdeconv_tpu_torch, flashdeconv_tpu):
        with pytest.raises(ValueError, match="fetch_dtype"):
            _deconvolve(pkg, st, ref, fetch_dtype="float8")


def test_deconvolve_runs_on_the_card_unless_asked(monkeypatch):
    st, ref, _ = _pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        flashdeconv_tpu_torch.tl.deconvolve(st, ref, **SMALL)


def test_package_exports_tl_and_version_as_jax():
    assert set(flashdeconv_tpu_torch.__all__) == set(flashdeconv_tpu.__all__)
    assert set(flashdeconv_tpu_torch.__all__) == {"FlashDeconv", "tl", "pl",
                                                  "__version__"}
    assert flashdeconv_tpu_torch.__version__ == flashdeconv_tpu.__version__
    assert flashdeconv_tpu_torch.tl.__all__ == flashdeconv_tpu.tl.__all__
    assert tio.__all__ == jio.__all__
