"""The port's whole fit against the JAX package's, on the CPU.

Seeded synthetic datasets (CSR Poisson counts on a 96 x 96 grid, so the
graph is banded and the port's fused tier takes it; and 3,000 spots at
irregular coordinates, which the gather tier takes) go through
``flashdeconv_tpu.FlashDeconv`` and ``flashdeconv_tpu_torch.FlashDeconv``.
The host stages of the port are bitwise copies of the JAX package's, so
the selected genes and lambda agree exactly; the solves are both f32 —
the JAX package's XLA tiers on the CPU, the port's plain sweeps — and
differ by a few ulp per sweep.
"""

import numpy as np
import pytest
import torch

import flashdeconv_tpu
import flashdeconv_tpu_torch
from conftest import make_synthetic
from flashdeconv_tpu_torch.utils.metrics import compute_correlation

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fits():
    Y, X, coords, truth = make_synthetic(
        n_spots=9216, n_genes=600, n_types=8, sparse_output=True
    )
    ref = flashdeconv_tpu.FlashDeconv()
    ref.fit(Y, X, coords)
    port = flashdeconv_tpu_torch.FlashDeconv(device="cpu")
    props = port.fit_transform(Y, X, coords)
    return ref, port, props, truth


def test_host_stages_agree_exactly(fits):
    ref, port, _, _ = fits
    np.testing.assert_array_equal(port.gene_idx_, ref.gene_idx_)
    assert port.lambda_used_ == ref.lambda_used_
    assert (port.adjacency_ != ref.adjacency_).nnz == 0


def test_fit_matches_jax(fits):
    """Same sweep count (a count one apart would mean the two f32 solves
    straddled tol on the last sweep; it does not happen on this data) and
    proportions within 1e-4."""
    ref, port, props, _ = fits
    assert port.info_["converged"] and ref.info_["converged"]
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(props, ref.proportions_, atol=1e-4)
    np.testing.assert_allclose(port.info_["final_objective"],
                               ref.info_["final_objective"], rtol=1e-5)
    assert set(port.timings_) >= {"gene_selection", "sketch", "solve"}


def test_fit_recovers_the_truth(fits):
    _, port, props, truth = fits
    assert props.shape == truth.shape
    np.testing.assert_allclose(props.sum(axis=1), 1.0, atol=1e-12)
    assert compute_correlation(props, truth) > 0.9
    assert port.beta_.dtype == np.float64 and (port.beta_ >= 0).all()


@pytest.fixture(scope="module")
def irregular_fits():
    Y, X, coords, truth = make_synthetic(
        n_spots=3000, n_genes=600, n_types=8, seed=3, grid=False,
        sparse_output=True,
    )
    ref = flashdeconv_tpu.FlashDeconv()
    ref.fit(Y, X, coords)
    port = flashdeconv_tpu_torch.FlashDeconv(device="cpu")
    props = port.fit_transform(Y, X, coords)
    return ref, port, props, truth


def test_irregular_fit_takes_the_gather_tier_and_matches_jax(irregular_fits):
    """Irregular coordinates (the gather tier): the same genes and lambda,
    the same sweeps, proportions within 1e-4."""
    ref, port, props, truth = irregular_fits
    np.testing.assert_array_equal(port.gene_idx_, ref.gene_idx_)
    assert port.lambda_used_ == ref.lambda_used_
    assert port.info_["converged"] and ref.info_["converged"]
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(props, ref.proportions_, atol=1e-4)
    np.testing.assert_allclose(port.info_["final_objective"],
                               ref.info_["final_objective"], rtol=1e-5)
    assert compute_correlation(props, truth) > 0.9


# -- the JAX class's keywords -----------------------------------------------------

NAMES = np.array([f"type_{k}" for k in range(5)])


@pytest.fixture(scope="module")
def named_fits():
    """A small irregular fit (1,200 spots, 5 types) through both classes,
    with ``cell_type_names``."""
    Y, X, coords, _ = make_synthetic(n_spots=1200, n_genes=400, n_types=5,
                                     seed=4, grid=False, sparse_output=True)
    ref = flashdeconv_tpu.FlashDeconv().fit(Y, X, coords,
                                            cell_type_names=NAMES)
    port = flashdeconv_tpu_torch.FlashDeconv(device="cpu").fit(
        Y, X, coords, cell_type_names=NAMES)
    return ref, port, (Y, X, coords)


def test_fit_takes_cell_type_names_as_jax(named_fits):
    """The attributes the JAX fit sets are equal; proportions within
    1e-5."""
    ref, port, _ = named_fits
    for attr in ("n_spots_", "n_genes_", "n_cell_types_"):
        assert getattr(port, attr) == getattr(ref, attr)
    assert (port.n_spots_, port.n_genes_, port.n_cell_types_) == (1200, 400,
                                                                  5)
    assert port.cell_type_names_ is NAMES and ref.cell_type_names_ is NAMES
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(port.proportions_, ref.proportions_,
                               atol=1e-5)


def test_fit_transform_forwards_keywords_to_fit(named_fits):
    _, port, (Y, X, coords) = named_fits
    again = flashdeconv_tpu_torch.FlashDeconv(device="cpu")
    props = again.fit_transform(Y, X, coords, cell_type_names=NAMES)
    assert again.cell_type_names_ is NAMES
    np.testing.assert_array_equal(props, port.proportions_)
    with pytest.raises(TypeError):
        again.fit_transform(Y, X, coords, cell_types=NAMES)


@pytest.mark.parametrize("model", [flashdeconv_tpu.FlashDeconv,
                                   flashdeconv_tpu_torch.FlashDeconv])
def test_wrong_cell_type_names_length_raises(named_fits, model):
    _, _, (Y, X, coords) = named_fits
    kw = {"device": "cpu"} if model is flashdeconv_tpu_torch.FlashDeconv \
        else {}
    with pytest.raises(ValueError, match=r"cell_type_names length \(4\) "
                                         r"does not match .* \(5\)"):
        model(**kw).fit(Y, X, coords, cell_type_names=NAMES[:4])


@pytest.mark.parametrize("kw", [
    {"warm_start": True}, {"device_outputs": True},
    {"fetch_dtype": "float16"}, {"fetch_dtype": np.float32},
    {"outputs": ("dominant",)}, {"outputs": ("proportions", "dominant")},
])
def test_constructor_keeps_the_output_and_surface_keywords(kw):
    """``warm_start``, ``device_outputs``, ``fetch_dtype`` (by name) and
    ``outputs`` are kept as the JAX class keeps them."""
    model = flashdeconv_tpu_torch.FlashDeconv(device="cpu", **kw)
    ref = flashdeconv_tpu.FlashDeconv(**kw)
    for key in kw:
        assert getattr(model, key) == getattr(ref, key)


@pytest.mark.parametrize("kw", [
    {"fetch_dtype": "int8"}, {"outputs": ()}, {"outputs": ("beta",)},
])
def test_constructor_value_checks_match_jax(kw):
    """The JAX class's ValueErrors come first, with its messages."""
    with pytest.raises(ValueError) as ref:
        flashdeconv_tpu.FlashDeconv(**kw)
    with pytest.raises(ValueError) as got:
        flashdeconv_tpu_torch.FlashDeconv(device="cpu", **kw)
    assert str(got.value) == str(ref.value)


def test_constructor_takes_the_jax_defaults():
    model = flashdeconv_tpu_torch.FlashDeconv(
        device="cpu", solver_dtype=np.float32, warm_start=False,
        device_outputs=False, fetch_dtype=None, outputs=["proportions"])
    assert model.outputs == ("proportions",)
    assert model.device_outputs is False and model.warm_start is False
    default = flashdeconv_tpu_torch.FlashDeconv(device="cpu")
    assert default.device_outputs is None and default.fetch_dtype is None
    assert np.dtype(default.solver_dtype) == np.float32


# -- the staged CSR path ------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_staged_csr_path_subsets_natively_as_jax(monkeypatch, dtype):
    """With the fused kernels' gate failing (as where the per-dtype libm
    self-test fails), both fits take the staged CSR path: the gene subset
    by ``native.csr_column_subset``, then normalisation and the host
    sketch. Its sketch operands are bitwise the JAX fit's; the fits give
    the same sweeps and proportions within 1e-4."""
    import flashdeconv_tpu.native as j_native
    import flashdeconv_tpu.utils.timing as j_timing
    import flashdeconv_tpu_torch.native as t_native
    import flashdeconv_tpu_torch.utils.timing as t_timing

    Y, X, coords, _ = make_synthetic(n_spots=900, n_genes=400, n_types=6,
                                     seed=5, grid=False, sparse_output=True)
    Y = Y.astype(dtype)
    subsets = []
    real = t_native.csr_column_subset
    monkeypatch.setattr(j_native, "fused_available", lambda Y: False)
    monkeypatch.setattr(t_native, "fused_available", lambda Y: False)
    monkeypatch.setattr(t_native, "csr_column_subset",
                        lambda *a: subsets.append(real(*a)) or subsets[-1])
    ref = flashdeconv_tpu.FlashDeconv()
    port = flashdeconv_tpu_torch.FlashDeconv(device="cpu")
    ref_ops = ref._pipeline_operands(Y, X, coords, None,
                                     j_timing.StageTimer())
    port_ops = port._pipeline_operands(Y, X, coords, None,
                                       t_timing.StageTimer())
    assert len(subsets) == 1 and subsets[0] is not None
    assert subsets[0].dtype == dtype
    np.testing.assert_array_equal(port.gene_idx_, ref.gene_idx_)
    for got, want in zip(port_ops[:2], ref_ops[:2]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (port_ops[2] != ref_ops[2]).nnz == 0
    ref.fit(Y, X, coords)
    port.fit(Y, X, coords)
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(port.proportions_, ref.proportions_,
                               atol=1e-4)
