"""The rest of ``FlashDeconv``'s surface on the port against the JAX
package's, on the CPU: ``warm_start``, ``fit_lambda_path``, the getters,
``summary``, ``__repr__`` and ``save`` / ``load`` across the packages.

Both packages get the same seeded inputs (tests/conftest.py's
``make_synthetic``: 400 spots on a 20 x 20 grid, 8 types) and solve in f32
— the JAX package on its XLA CPU tiers, the port with its plain sweeps —
so the host stages agree exactly and the solves to 1e-5 on beta with the
same sweeps (tests/test_torch_solver.py's bound for one f32 solve).
"""

import numpy as np
import pytest
import torch

import flashdeconv_tpu
from conftest import make_synthetic
from flashdeconv_tpu_torch import FlashDeconv

torch.set_num_threads(2)

FIT = dict(sketch_dim=128, n_hvg=300, n_markers_per_type=10, random_state=0)
PORT = dict(FIT, device="cpu")
NAMES = np.array([f"t{k}" for k in range(8)])


@pytest.fixture(scope="module")
def small():
    return make_synthetic(n_spots=400, n_genes=600, n_types=8, seed=0)


@pytest.fixture(scope="module")
def fitted(small):
    Y, X, coords, _ = small
    port = FlashDeconv(**PORT).fit(Y, X, coords, cell_type_names=NAMES)
    ref = flashdeconv_tpu.FlashDeconv(**FIT).fit(Y, X, coords,
                                                 cell_type_names=NAMES)
    return port, ref


# -- warm_start --------------------------------------------------------------------

def test_warm_start_refits_from_the_previous_beta_as_jax(small):
    """The second fit starts from the first's beta_: at most half the cold
    sweeps (the JAX package's test) and the JAX warm re-fit's sweeps, its
    proportions to 1e-5."""
    Y, X, coords, _ = small
    port = FlashDeconv(warm_start=True, **PORT)
    ref = flashdeconv_tpu.FlashDeconv(warm_start=True, **FIT)
    port.fit(Y, X, coords)
    ref.fit(Y, X, coords)
    cold = port.info_["n_iterations"]
    p_cold = port.proportions_.copy()
    port.fit(Y, X, coords)
    ref.fit(Y, X, coords)
    assert port.info_["n_iterations"] <= max(cold // 2, 2)
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(port.proportions_, p_cold, atol=1e-3)
    np.testing.assert_allclose(port.proportions_, ref.proportions_,
                               atol=1e-5)


def test_warm_start_needs_matching_shapes(small):
    """A previous beta_ of another shape is ignored: a cold fit."""
    Y, X, coords, _ = small
    cold = FlashDeconv(**PORT).fit(Y, X, coords)
    m = FlashDeconv(warm_start=True, **PORT)
    m.beta_ = np.ones((3, 8))
    m.fit(Y, X, coords)
    assert m.info_["n_iterations"] == cold.info_["n_iterations"]
    np.testing.assert_array_equal(m.beta_, cold.beta_)


def test_warm_start_from_device_outputs(small):
    """On the device-outputs path the warm start reads beta_ through its
    lazy fetch, as in the JAX class."""
    Y, X, coords, _ = small
    m = FlashDeconv(warm_start=True, device_outputs=True, **PORT)
    m.fit(Y, X, coords)
    cold = m.info_["n_iterations"]
    m.fit(Y, X, coords)
    assert m.info_["n_iterations"] <= max(cold // 2, 2)


# -- fit_lambda_path --------------------------------------------------------------------

LAMBDAS = np.array([2.0, 0.5, 8.0])


@pytest.mark.parametrize("n_shards", [None, 2])
def test_lambda_path_matches_jax_f32(small, n_shards):
    """Ascending lambdas, each solve warm-started from the last; the port
    against JAX's f32 path (on as many CPU devices): the same sweeps at
    every lambda and beta to 1e-5; the model is left at the last lambda."""
    Y, X, coords, _ = small
    port = FlashDeconv(n_shards=n_shards, **PORT)
    ref = flashdeconv_tpu.FlashDeconv(n_shards=n_shards, **FIT)
    path = port.fit_lambda_path(Y, X, coords, lambdas=LAMBDAS)
    ref_path = ref.fit_lambda_path(Y, X, coords, lambdas=LAMBDAS)
    assert [r["lambda"] for r in path] == [0.5, 2.0, 8.0]
    for r, j in zip(path, ref_path):
        assert r["lambda"] == j["lambda"]
        assert r["info"]["n_iterations"] == j["info"]["n_iterations"]
        np.testing.assert_allclose(r["beta"], j["beta"], atol=1e-5)
        np.testing.assert_allclose(r["proportions"], j["proportions"],
                                   atol=1e-5)
        assert ("n_shards" in r["info"]) == (n_shards is not None)
    assert port._fitted and port.lambda_used_ == 8.0
    np.testing.assert_array_equal(port.proportions_, path[-1]["proportions"])
    np.testing.assert_array_equal(port.beta_, path[-1]["beta"])
    assert port.info_ is path[-1]["info"]


def test_lambda_path_against_cold_fits(small):
    """Against a cold fit at each lambda: proportions to 5e-5 (the f32
    solves stop at tol 1e-4 from different starts; measured 8.6e-6 on
    these inputs, 4-5 warm sweeps against 9 cold) and no more sweeps after
    the first lambda than the first took."""
    Y, X, coords, _ = small
    path = FlashDeconv(**PORT).fit_lambda_path(Y, X, coords,
                                               lambdas=LAMBDAS)
    for r in path:
        solo = FlashDeconv(lambda_spatial=r["lambda"], **PORT).fit(Y, X,
                                                                 coords)
        np.testing.assert_allclose(r["proportions"], solo.proportions_,
                                   atol=5e-5)
    first = path[0]["info"]["n_iterations"]
    assert max(r["info"]["n_iterations"] for r in path[1:]) <= first


def test_lambda_path_default_grid_is_jax(small):
    Y, X, coords, _ = small
    path = FlashDeconv(**PORT).fit_lambda_path(Y, X, coords)
    ref = flashdeconv_tpu.FlashDeconv(**FIT).fit_lambda_path(Y, X, coords)
    assert len(path) == 5
    assert [r["lambda"] for r in path] == [r["lambda"] for r in ref]
    assert [r["info"]["n_iterations"] for r in path] == [
        r["info"]["n_iterations"] for r in ref]


@pytest.mark.parametrize("lambdas, match", [
    (np.array([]), "non-empty"), (np.array([-1.0, 0.5]), "non-negative"),
])
def test_lambda_path_rejects_bad_lambdas_as_jax(small, lambdas, match):
    Y, X, coords, _ = small
    for model in (FlashDeconv(**PORT), flashdeconv_tpu.FlashDeconv(**FIT)):
        with pytest.raises(ValueError, match=match):
            model.fit_lambda_path(Y, X, coords, lambdas=lambdas)
        assert "_fused_xty" not in model.__dict__


def test_lambda_path_resets_a_stale_dominant(small):
    """A previous device-output fit's argmax must not survive the path."""
    Y, X, coords, _ = small
    m = FlashDeconv(device_outputs=True, outputs=("proportions", "dominant"),
                    **PORT).fit(Y, X, coords)
    assert m.dominant_ is not None
    m.fit_lambda_path(Y, X, coords, lambdas=np.array([1.0]))
    assert m.dominant_ is None
    np.testing.assert_array_equal(m.get_dominant_cell_type(),
                                  np.argmax(m.proportions_, axis=1))


# -- getters, summary, repr ------------------------------------------------------------

def test_getters_summary_and_repr_match_jax(fitted):
    port, ref = fitted
    assert port.get_cell_type_proportions() is port.proportions_
    assert port.get_abundances() is port.beta_
    np.testing.assert_array_equal(port.get_dominant_cell_type(),
                                  np.argmax(port.proportions_, axis=1))
    np.testing.assert_allclose(port.get_cell_type_proportions(),
                               ref.get_cell_type_proportions(), atol=1e-5)
    got, want = port.summary(), ref.summary()
    assert got.keys() == want.keys()
    objective = got.pop("final_objective"), want.pop("final_objective")
    assert got == want
    np.testing.assert_allclose(*objective, rtol=1e-5)
    assert repr(port) == repr(ref)
    assert "status=fitted" in repr(port)


def test_unfitted_model_raises_as_jax(tmp_path):
    for model in (FlashDeconv(device="cpu"), flashdeconv_tpu.FlashDeconv()):
        assert model.summary() == {"fitted": False}
        assert "status=not fitted" in repr(model)
        for call in (model.get_cell_type_proportions, model.get_abundances,
                     model.get_dominant_cell_type,
                     lambda: model.save(str(tmp_path / "x.npz"))):
            with pytest.raises(RuntimeError, match="not been fitted"):
                call()
    assert repr(FlashDeconv(device="cpu")) == repr(
        flashdeconv_tpu.FlashDeconv())


# -- save / load across the packages ------------------------------------------------------

def _same_state(a, b):
    np.testing.assert_array_equal(a.beta_, b.beta_)
    np.testing.assert_array_equal(a.proportions_, b.proportions_)
    np.testing.assert_array_equal(a.gene_idx_, b.gene_idx_)
    assert a.lambda_used_ == b.lambda_used_
    assert a.info_ == b.info_
    assert (a.n_spots_, a.n_genes_, a.n_cell_types_) == (
        b.n_spots_, b.n_genes_, b.n_cell_types_)
    assert (a.adjacency_ != b.adjacency_).nnz == 0
    np.testing.assert_array_equal(a.cell_type_names_, b.cell_type_names_)
    assert a.summary() == b.summary()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_across_the_packages(fitted, tmp_path, writer):
    """A file written by either package has the same keys as the other's
    and loads in both to identical arrays and state."""
    port, ref = fitted
    model = port if writer == "port" else ref
    path = tmp_path / f"{writer}.npz"
    model.save(str(path))
    other = tmp_path / "other.npz"
    (ref if writer == "port" else port).save(str(other))
    with np.load(path) as f, np.load(other) as g:
        assert sorted(f.files) == sorted(g.files)
        for key in f.files:
            assert f[key].dtype == g[key].dtype, key
    by_port = FlashDeconv.load(str(path), **PORT)
    by_jax = flashdeconv_tpu.FlashDeconv.load(str(path), **FIT)
    _same_state(by_port, model)
    _same_state(by_jax, model)
    assert by_port.summary()["fitted"]


def test_loaded_model_warm_starts(small, tmp_path):
    Y, X, coords, _ = small
    m = FlashDeconv(warm_start=True, **PORT).fit(Y, X, coords)
    m.save(str(tmp_path / "c.npz"))
    r = FlashDeconv.load(str(tmp_path / "c.npz"), warm_start=True, **PORT)
    r.fit(Y, X, coords)
    assert r.info_["n_iterations"] <= max(m.info_["n_iterations"] // 2, 2)


def test_save_through_the_device_path(small, tmp_path):
    """save() reads beta_ and proportions_ through their lazy fetches."""
    Y, X, coords, _ = small
    m = FlashDeconv(device_outputs=True, outputs=("dominant",), **PORT).fit(
        Y, X, coords)
    m.save(str(tmp_path / "d.npz"))
    r = FlashDeconv.load(str(tmp_path / "d.npz"), device="cpu")
    np.testing.assert_array_equal(r.proportions_, m.proportions_)
    np.testing.assert_array_equal(r.beta_, m.beta_)
