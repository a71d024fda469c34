"""The port's CountSketch projection and dense-count sketch against the JAX
package's, on the CPU.

The same seeded inputs (numpy) go through the JAX Pallas kernel
``countsketch_project_pallas`` (in TPU interpret mode), scipy's
``Y @ op.to_csr()`` and the port's plain version of its CUDA kernel, held
to ``2e-5 * max(max|ref|, 1)``, the JAX package's own CountSketch bound
(``benchmarks/hw_parity.py``, check 4). The kernel's own arithmetic is
checked on the card (``tests/test_torch_kernels.py``); here its gene order
is replayed in Python against the plain version, bit for bit. Then the
route ``countsketch_project`` takes, ``sketch_data``'s device route
against JAX's, and a whole dense-count fit with both packages' device
route forced on the CPU.
"""

import numpy as np
import pytest
import torch
from scipy import sparse

import flashdeconv_tpu
import flashdeconv_tpu.core.sketching as j_sketching
import flashdeconv_tpu_torch
import flashdeconv_tpu_torch.core.sketching as t_sketching
import flashdeconv_tpu_torch.ops.countsketch as t_cs
from conftest import make_synthetic

torch.set_num_threads(2)

SHAPES = [(n, g, d) for n in (300, 1024) for g in (1100, 4097)
          for d in (64, 100, 512)]


def _inputs(n, g, d, seed=0):
    """Non-negative f32 counts with zeros, as log-CPM rows look, and a
    leverage-weighted operator."""
    rng = np.random.default_rng(seed)
    Y = rng.random((n, g), dtype=np.float32) * 6.0
    Y *= rng.random((n, g)) < 0.4
    op = t_sketching.make_countsketch_op(g, d, rng.random(g) + 0.1,
                                         random_state=seed)
    return Y, op


def _tensors(op):
    return (torch.from_numpy(op.buckets),
            torch.from_numpy(op.weights.astype(np.float32)))


def _plain(Y, op):
    b, w = _tensors(op)
    return t_cs.countsketch_project_reference(torch.from_numpy(Y), b, w,
                                              op.sketch_dim).numpy()


def _assert_within_bound(got, ref):
    tol = 2e-5 * max(float(np.abs(ref).max()), 1.0)
    assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("n,g,d", SHAPES)
def test_plain_version_matches_pallas_kernel(n, g, d):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from flashdeconv_tpu.ops.countsketch import countsketch_project_pallas

    Y, op = _inputs(n, g, d, seed=n + g + d)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(countsketch_project_pallas(
            jnp.asarray(Y), jnp.asarray(op.buckets),
            jnp.asarray(op.weights, dtype=jnp.float32), d))
    assert pallas.shape == (n, d)
    _assert_within_bound(_plain(Y, op), pallas)


@pytest.mark.parametrize("n,g,d", SHAPES)
def test_plain_version_matches_scipy(n, g, d):
    Y, op = _inputs(n, g, d, seed=n + g + d)
    _assert_within_bound(_plain(Y, op), Y.astype(np.float64) @ op.to_csr())


@pytest.mark.parametrize("g,d", [(1100, 64), (4097, 100), (2100, 2048)])
def test_kernel_gene_order_matches_plain_version_bitwise(g, d):
    """The CUDA kernel's order, replayed: tile by tile, each bucket's genes
    of the tile as ``gene_plan`` lists them, summed from 0. Equal bit for
    bit to the plain version (the kernel fuses each multiply-add, so on
    the card the two agree to the bound, not bitwise)."""
    Y, op = _inputs(24, g, d, seed=g)
    b, w = _tensors(op)
    tile = 1024
    genes, ws, ptr = t_cs.gene_plan(b, w, d, tile)
    assert genes.dtype == ptr.dtype == torch.int32
    assert ptr.shape == (-(-g // tile) * d + 1,) and int(ptr[-1]) == g
    assert sorted(genes.tolist()) == list(range(g))
    Yt = torch.from_numpy(Y)
    out = torch.zeros(Y.shape[0], d)
    for t in range(-(-g // tile)):
        for c in range(d):
            span = genes[int(ptr[t * d + c]):int(ptr[t * d + c + 1])]
            assert (span // tile == t).all() and (b[span.long()] == c).all()
            assert (span[1:] > span[:-1]).all()
            for i in range(int(ptr[t * d + c]), int(ptr[t * d + c + 1])):
                out[:, c] += ws[i] * Yt[:, genes[i]]
    assert torch.equal(out, t_cs.countsketch_project_reference(Yt, b, w, d))


def test_gene_plan_rejects_buckets_out_of_range():
    b = torch.tensor([0, 3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        t_cs.gene_plan(b, torch.ones(3), 4, 1024)


@pytest.mark.parametrize("dev,n,g,want", [
    ("cuda", 1024, 4096, True),
    ("cuda", 262144, 5001, True),
    ("cuda", 1023, 4096, False),
    ("cuda", 1024, 4095, False),
    ("cpu", 1024, 4096, False),
    ("cpu", 262144, 5001, False),
])
def test_kernel_route_is_the_jax_gate(dev, n, g, want):
    """JAX runs its Pallas kernel on the accelerator iff G >= 4096 and
    N >= 1024 (less its VMEM budget); the port its CUDA kernel the same."""
    assert t_cs.kernel_route(torch.device(dev), n, g) is want


@pytest.mark.parametrize("use_kernel,route", [
    (None, "matmul"), (False, "matmul"), (True, "plain"),
])
def test_countsketch_project_route_on_cpu(monkeypatch, use_kernel, route):
    """On the CPU the default route is the matmul; ``use_kernel=True``
    runs the kernel's plain version. Both agree with JAX's
    ``countsketch_project`` (its XLA matmul on the CPU)."""
    from flashdeconv_tpu.ops.countsketch import countsketch_project

    calls = []
    for name, tag in (("_matmul_project", "matmul"),
                      ("countsketch_project_reference", "plain")):
        fn = getattr(t_cs, name)
        monkeypatch.setattr(t_cs, name, lambda *a, _f=fn, _t=tag, **k: (
            calls.append(_t), _f(*a, **k))[1])
    Y, op = _inputs(1024, 4097, 100, seed=7)
    got = t_cs.countsketch_project(Y, op, use_kernel=use_kernel,
                                   device="cpu")
    assert calls == [route]
    assert got.dtype == torch.float32 and got.shape == (1024, 100)
    _assert_within_bound(got.numpy(), np.asarray(countsketch_project(Y, op)))


def test_kernel_wrapper_validates_operands():
    Y, op = _inputs(8, 50, 16)
    b, w = _tensors(op)
    Yt = torch.from_numpy(Y)
    before = t_cs.countsketch_project_kernel.launches
    bad = [
        (Yt.double(), b, w, {}),
        (Yt, b.long(), w, {}),
        (Yt, b, w[:-1], {}),
        (Yt.T.contiguous().T, b, w, {}),
        (Yt, b, w, {"out": torch.empty(8, 15)}),
        (Yt[0], b, w, {}),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            t_cs.countsketch_project_kernel(*args[:3], 16, **args[3])
    out = torch.full((8, 16), float("nan"))
    got = t_cs.countsketch_project_kernel(Yt, b, w, 16, out=out)
    assert got is out
    assert torch.equal(out, t_cs.countsketch_project_reference(Yt, b, w, 16))
    assert t_cs.countsketch_project_kernel.launches == before


# -- sketch_data ---------------------------------------------------------------

@pytest.mark.parametrize("n,g,d", [(25, 70, 16), (1100, 4200, 128)])
def test_sketch_data_device_route_matches_jax(n, g, d):
    """``backend="device"`` on the CPU against JAX's on its CPU backend:
    both project in f32 through a dense Omega, within 1e-5 (as
    ``tests/test_sketching.py`` holds JAX's device and host routes)."""
    rng = np.random.RandomState(n)
    Y, X = rng.rand(n, g), rng.rand(3, g)
    lev = rng.rand(g)
    jy, jx, jom = j_sketching.sketch_data(Y, X, d, lev, random_state=0,
                                          backend="device")
    ty, tx, tom = t_sketching.sketch_data(Y, X, d, lev, random_state=0,
                                          backend="device", device="cpu")
    assert ty.dtype == tx.dtype == np.float32 == jy.dtype
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-5)
    assert (tom != jom).nnz == 0
    hy, hx, _ = t_sketching.sketch_data(Y, X, d, lev, random_state=0,
                                        backend="host")
    np.testing.assert_allclose(ty, hy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx, hx, rtol=1e-5, atol=1e-5)


_Y = np.random.RandomState(0).rand(20, 40)
_X = np.random.RandomState(1).rand(3, 40)


@pytest.mark.parametrize("kwargs,match", [
    ({"backend": "gpu"}, "Unknown backend"),
    ({"backend": "device", "sparse": True}, "requires dense Y"),
    ({"backend": "device", "method": "rademacher"}, "only available"),
    ({"method": "gaussian"}, "Unknown sketching method"),
])
def test_sketch_data_raises_as_jax_does(kwargs, match):
    kwargs = dict(kwargs)
    Y = sparse.csr_matrix(_Y) if kwargs.pop("sparse", False) else _Y
    for m, extra in ((j_sketching, {}), (t_sketching, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            m.sketch_data(Y, _X, 8, random_state=0, **kwargs, **extra)


@pytest.mark.parametrize("dense,available,route", [
    (True, False, "host"), (True, True, "device"), (False, True, "host"),
])
def test_sketch_data_auto_route(monkeypatch, dense, available, route):
    """``"auto"`` projects dense Y on the device when the device is a CUDA
    device (forced here), sparse Y always on the host."""
    assert t_sketching._device_projection_available("cuda")
    assert not t_sketching._device_projection_available("cpu")
    monkeypatch.setattr(t_sketching, "_device_projection_available",
                        lambda device: available)
    Y = _Y if dense else sparse.csr_matrix(_Y)
    got = t_sketching.sketch_data(Y, _X, 8, random_state=0, device="cpu")
    host = t_sketching.sketch_data(Y, _X, 8, random_state=0, backend="host")
    assert got[0].dtype == (np.float32 if route == "device" else np.float64)
    if route == "host":
        np.testing.assert_array_equal(got[0], host[0])
    else:
        np.testing.assert_allclose(got[0], host[0], rtol=1e-5, atol=1e-5)


def test_sketch_data_device_route_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device route runs there")
    with pytest.raises(RuntimeError, match="is_available"):
        t_sketching.sketch_data(_Y, _X, 8, random_state=0, backend="device")


# -- the whole dense fit ----------------------------------------------------------

N_GENES = 4200


@pytest.fixture(scope="module")
def dense_fits():
    """2,000 spots at irregular coordinates x 4,200 genes of dense counts,
    every gene kept (``n_hvg`` = G), fitted by both packages with their
    device route forced on the CPU."""
    Y, X, coords, truth = make_synthetic(n_spots=2000, n_genes=N_GENES,
                                         n_types=8, seed=5, grid=False)
    assert isinstance(Y, np.ndarray)
    calls = []
    project = t_cs.countsketch_project
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_sketching, "_device_projection_available", lambda: True)
        mp.setattr(t_sketching, "_device_projection_available",
                   lambda device: True)
        mp.setattr(t_cs, "countsketch_project", lambda Y, op, **k: (
            calls.append(Y.shape), project(Y, op, **k))[1])
        ref = flashdeconv_tpu.FlashDeconv(n_hvg=N_GENES)
        ref.fit(Y, X, coords)
        port = flashdeconv_tpu_torch.FlashDeconv(n_hvg=N_GENES, device="cpu")
        props = port.fit_transform(Y, X, coords)
    return ref, port, props, truth, calls


def test_dense_fit_sketches_through_the_device_route(dense_fits):
    ref, port, _, _, calls = dense_fits
    G = len(port.gene_idx_)
    assert G >= t_cs.KERNEL_MIN_GENES
    assert calls == [(2000, G), (8, G)]
    assert "sketch" in port.timings_


def test_dense_fit_matches_jax(dense_fits):
    """The same genes and sweeps, proportions within 1e-4. Both sketches
    are f32 matmuls (XLA's and torch's), so lambda agrees to rounding."""
    ref, port, props, truth, _ = dense_fits
    np.testing.assert_array_equal(port.gene_idx_, ref.gene_idx_)
    np.testing.assert_allclose(port.lambda_used_, ref.lambda_used_,
                               rtol=1e-5)
    assert port.info_["converged"] and ref.info_["converged"]
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(props, ref.proportions_, atol=1e-4)
    np.testing.assert_allclose(props.sum(axis=1), 1.0, atol=1e-12)
    from flashdeconv_tpu_torch.utils.metrics import compute_correlation

    assert compute_correlation(props, truth) > 0.9
