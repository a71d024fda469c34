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
