"""The fit's outputs on the port against the JAX package's, on the CPU.

``return_device`` on every solve (single device: the fused, re-sorted
fused and gather tiers; the halo plan and the banded mesh on 2 and 4 CPU
shards), the one fetch of beta (``fetch_to_host``, bitwise
``.to(float64)``), a device Xty, the chunked native Xty pass and its
streamed feed, and ``FlashDeconv``'s device outputs (``device_outputs=True``
forced on the CPU, as the JAX package's own tests do): proportions
normalised on the device, ``fetch_dtype``, ``outputs`` and the lazy
``beta_`` / ``proportions_``.

Bounds: within the port, a device result equals the host one bit for bit
(the fetch is exact). Against the JAX package, one f32 solve agrees to
1e-5 on beta with the same sweeps (tests/test_torch_solver.py); device
outputs are held to the JAX package's own bounds for that path
(tests/test_aux.py ``TestDeviceOutputs`` / ``TestWirePayloadControls``):
row sums within 1e-5, proportions and lazy beta within 1e-6 of the host
path, f16 within 5e-4. The dominant type is compared where the top two
proportions differ by more than 1e-5 (an f32 ulp may flip a closer tie).
"""

import numpy as np
import pytest
import torch
from scipy import sparse

import flashdeconv_tpu
from conftest import make_synthetic
from flashdeconv_tpu import native as jnative
from flashdeconv_tpu import parallel as jpar
from flashdeconv_tpu.core import solver as jsolver
from flashdeconv_tpu.core.sketching import make_countsketch_op
from flashdeconv_tpu_torch import FlashDeconv
from flashdeconv_tpu_torch import native as tnative
from flashdeconv_tpu_torch import parallel as tpar
from flashdeconv_tpu_torch.core import deconv as tdeconv
from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.utils.graph import build_knn_graph, grid_coords

torch.set_num_threads(2)

KW = dict(lambda_=0.3, rho=0.01, max_iter=60, tol=1e-4)
FIT = dict(sketch_dim=128, n_hvg=300, n_markers_per_type=10, random_state=0)


def sketch_problem(coords, n_types=7, d=48, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n_types, d)
    Y = np.abs(rng.randn(coords.shape[0], n_types)) @ X \
        + 0.05 * rng.randn(coords.shape[0], d)
    return Y, X, build_knn_graph(coords, k=6)


def problem(layout):
    """Coordinates that take the fused tier (a 96 x 96 grid), the fused
    tier after the scrambled-grid re-sort, or the gather tier."""
    if layout == "irregular":
        coords = np.random.RandomState(1).rand(900, 2) * 30
    else:
        coords = grid_coords(side=96)
        if layout == "scrambled":
            coords = coords[np.random.RandomState(0).permutation(9216)]
    return (*sketch_problem(coords), coords)


# -- the fetch --------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("float32", (1000, 7), 4096), ("float32", (1000, 7), 1 << 25),
    ("float16", (333, 5), 100), ("bfloat16", (333, 5), 100),
    ("transposed", (7, 600), 1000), ("uint8", (5001,), 1000),
    ("float32", (0, 4), 4096),
])
def test_fetch_is_bitwise_the_cast(case):
    """Every chunking (one chunk, many, an uneven tail), a non-contiguous
    tensor, bf16 (which numpy lacks), uint8 to int64 and an empty tensor:
    the values of ``t.to(dtype)``, bit for bit."""
    name, shape, chunk = case
    g = torch.Generator().manual_seed(0)
    if name == "uint8":
        t = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
        dtype, want = np.int64, torch.int64
    else:
        t = torch.rand(shape, generator=g) * 3.0
        if name == "transposed":
            t = t.T
        elif name != "float32":
            t = t.to(getattr(torch, name))
        dtype, want = np.float64, torch.float64
    got = tsolver.fetch_to_host(t, dtype, chunk_bytes=chunk)
    assert got.dtype == dtype and got.shape == tuple(t.shape)
    np.testing.assert_array_equal(got, t.to(want).numpy())


# -- return_device ----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["grid", "scrambled", "irregular"])
def test_solve_return_device_is_the_host_solve(layout):
    """``return_device=True`` leaves the contiguous f32 beta, un-padded and
    un-permuted, on the device: its f64 cast is the host solve's beta bit
    for bit, with the same info; ``bcd_solve`` forwards the keyword. The
    JAX ``bcd_solve(return_device=True)`` agrees to 1e-5, same sweeps."""
    Y, X, A, coords = problem(layout)
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    tier = {"irregular": "GatherTier"}.get(layout, "FusedBandedTier")
    assert type(prob.tier).__name__ == tier
    assert (prob.perm is not None) == (layout == "scrambled")
    host, info = prob.solve(**KW)
    dev, info_d = prob.solve(return_device=True, **KW)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    assert dev.shape == (Y.shape[0], X.shape[0]) and dev.is_contiguous()
    np.testing.assert_array_equal(dev.double().numpy(), host)
    assert info_d == info
    one, _ = tsolver.bcd_solve(Y, X, A, coords=coords, device="cpu",
                               return_device=True, **KW)
    assert torch.equal(one, dev)

    ref, ref_info = jsolver.bcd_solve(Y, X, A, coords=coords,
                                      return_device=True, **KW)
    assert not isinstance(ref, np.ndarray)
    assert info["n_iterations"] == ref_info["n_iterations"]
    np.testing.assert_allclose(host, np.asarray(ref), atol=1e-5)


def test_zero_sweeps_return_host_uniform_even_on_the_device_path():
    Y, X, A, coords = problem("irregular")
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    beta, info = prob.solve(max_iter=0, return_device=True)
    ref, ref_info = jsolver.bcd_solve(Y, X, A, max_iter=0,
                                      return_device=True)
    assert isinstance(beta, np.ndarray)
    np.testing.assert_array_equal(beta, ref)
    assert info == ref_info


def test_xty_as_a_device_tensor_is_the_host_xty():
    """A torch Xty (the streamed feed's) prepares the same problem as the
    host f64 one: beta bitwise, non-finite rows zeroed as before."""
    Y, X, A, coords = problem("grid")
    xty = Y @ X.T
    xty[[5, 77]] = np.nan
    yty = float(np.sum(Y * Y))
    host = tsolver.prepare_bcd(None, X, A, coords=coords, xty=xty, yty=yty,
                               device="cpu")
    tens = tsolver.prepare_bcd(None, X, A, coords=coords,
                               xty=torch.from_numpy(xty.astype(np.float32)),
                               yty=yty, device="cpu")
    assert tens.n_nonfinite_spots == host.n_nonfinite_spots == 2
    b1, i1 = host.solve(**KW)
    b2, i2 = tens.solve(**KW)
    np.testing.assert_array_equal(b1, b2)
    assert i1 == i2
    with pytest.raises(ValueError, match="xty shape"):
        tsolver.prepare_bcd(None, X, A, xty=torch.zeros(3, X.shape[0]),
                            yty=1.0, device="cpu")


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("layout", ["grid", "scrambled", "irregular"])
def test_sharded_return_device_is_the_host_solve(layout, n_shards):
    """The banded mesh (a grid, and a shuffled grid re-sorted into one)
    and the halo plan (irregular coordinates): the device beta is on the
    mesh's main device in the original spot order, bitwise the host
    solve's; against the JAX ``prepare_sharded_bcd(...).solve(
    return_device=True)`` on as many CPU devices, 1e-5 with the same
    sweeps."""
    Y, X, A, coords = problem(layout)
    tp = tpar.prepare_sharded_bcd(Y, X, A, coords=coords,
                                  mesh=("cpu",) * n_shards, device="cpu")
    assert tp.strategy == ("halo" if layout == "irregular" else "banded")
    assert (tp._perm is not None) == (layout == "scrambled")
    host, info = tp.solve(**KW)
    dev, info_d = tp.solve(return_device=True, **KW)
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    assert dev.shape == (Y.shape[0], X.shape[0])
    np.testing.assert_array_equal(dev.double().numpy(), host)
    assert info_d == info and info["n_shards"] == n_shards

    jp = jpar.prepare_sharded_bcd(Y, X, A, coords=coords, n_shards=n_shards)
    assert jp.strategy == tp.strategy
    ref, ref_info = jp.solve(return_device=True, **KW)
    assert not isinstance(ref, np.ndarray)
    assert info["n_iterations"] == ref_info["n_iterations"]
    np.testing.assert_allclose(host, np.asarray(ref), atol=1e-5)


# -- the chunked Xty pass and its streamed feed -----------------------------------------

def _csr(n_rows=701, n_cols=500, density=0.08, dtype=np.float64, seed=17):
    rng = np.random.RandomState(seed)
    Y = sparse.random(n_rows, n_cols, density=density, format="csr",
                      random_state=rng, dtype=np.float64)
    Y.data = np.round(Y.data * 20.0) + 1.0
    return Y.astype(dtype)


def _xty_calls(kind, Y, gene_idx, op, Xsk, chunk_rows=None):
    """(the port's single call, the port's chunks, JAX's chunks)."""
    colscale = None
    if kind == "colscale":
        colscale = np.random.RandomState(9).rand(len(gene_idx)) + 0.5
    calls = []
    for pkg in (tnative, jnative):
        args = (Y, gene_idx) + ((colscale,) if kind == "colscale" else ())
        args += (op.buckets, op.weights, op.sketch_dim, Xsk)
        full = getattr(pkg, f"fused_{kind}_xty")
        chunked = getattr(pkg, f"fused_{kind}_xty_chunks")
        kw = {} if chunk_rows is None else {"chunk_rows": chunk_rows}
        calls.append((full(*args), chunked(*args, **kw)))
    return calls[0][0], calls[0][1], calls[1][1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["log1pcpm", "colscale"])
def test_chunked_xty_is_bitwise_jax_and_the_single_call(kind, dtype):
    """Row spans (an uneven tail: 701 = 5 x 128 + 61) and Xty chunks bit
    for bit JAX's and the single call's; YtY's partial sums add up to the
    single call's to 1e-12 (only their association differs)."""
    assert tnative.XTY_STREAM_CHUNK_ROWS == jnative.XTY_STREAM_CHUNK_ROWS
    Y = _csr(dtype=dtype)
    gene_idx = np.sort(np.random.RandomState(6).choice(500, 150,
                                                       replace=False))
    op = make_countsketch_op(len(gene_idx), 64, random_state=2)
    Xsk = np.random.RandomState(7).standard_normal((6, 64))
    (xty, yty), ours, theirs = _xty_calls(kind, Y, gene_idx, op, Xsk, 128)
    ours, theirs = list(ours), list(theirs)
    assert [c[:2] for c in ours] == [c[:2] for c in theirs]
    assert ours[0][:2] == (0, 128) and ours[-1][:2] == (640, 701)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a[2], b[2])
        assert a[3] == b[3]
    np.testing.assert_array_equal(np.concatenate([c[2] for c in ours]), xty)
    np.testing.assert_allclose(sum(c[3] for c in ours), yty, rtol=1e-12)
    # the default chunk (one chunk here) is the single call
    _, one, _ = _xty_calls(kind, Y, gene_idx, op, Xsk)
    (a, b, part, y1), = list(one)
    assert (a, b) == (0, 701) and y1 == yty
    np.testing.assert_array_equal(part, xty)


def test_stream_xty_is_the_f32_cast_of_the_single_call():
    Y = _csr()
    gene_idx = np.arange(0, 500, 3)
    op = make_countsketch_op(len(gene_idx), 64, random_state=2)
    Xsk = np.random.RandomState(7).standard_normal((6, 64))
    xty, yty = tnative.fused_log1pcpm_xty(Y, gene_idx, op.buckets,
                                          op.weights, 64, Xsk)
    chunks = tnative.fused_log1pcpm_xty_chunks(
        Y, gene_idx, op.buckets, op.weights, 64, Xsk, chunk_rows=100)
    got, got_yty = tdeconv.stream_xty(chunks, 701, 6, torch.device("cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), xty.astype(np.float32))
    np.testing.assert_allclose(got_yty, yty, rtol=1e-12)


@pytest.fixture(scope="module")
def grid_counts():
    """Poisson counts on a 96 x 96 grid (the fused tier), CSR."""
    return make_synthetic(n_spots=9216, n_genes=600, n_types=8, seed=2,
                          sparse_output=True)


@pytest.mark.parametrize("poisoned", [False, True])
def test_streamed_fit_is_the_unstreamed_fit(grid_counts, monkeypatch,
                                            poisoned):
    """A fit whose Xty streams to the device in chunks (forced on the CPU,
    4,000-row chunks) gives the unstreamed fit's beta bit for bit; with
    NaN counts the poisoned rows are zeroed and the feed re-streamed."""
    Y, X, coords, _ = grid_counts
    if poisoned:
        Y = Y.copy()
        Y.data[Y.indptr[40]] = np.nan
    base = FlashDeconv(device="cpu", device_outputs=False).fit(Y, X, coords)
    calls = []
    orig = tdeconv.stream_xty

    def spy(*args):
        calls.append(args[1])
        return orig(*args)

    monkeypatch.setattr(tnative, "XTY_STREAM_CHUNK_ROWS", 4000)
    monkeypatch.setattr(tdeconv, "stream_xty", spy)
    monkeypatch.setattr(FlashDeconv, "_streams_xty",
                        lambda self, n: n > tnative.XTY_STREAM_CHUNK_ROWS)
    streamed = FlashDeconv(device="cpu", device_outputs=False).fit(
        Y, X, coords)
    assert calls == [9216] * (2 if poisoned else 1)
    np.testing.assert_array_equal(streamed.beta_, base.beta_)
    assert streamed.info_["n_iterations"] == base.info_["n_iterations"]
    assert np.isfinite(streamed.info_["final_objective"])
    np.testing.assert_allclose(streamed.info_["final_objective"],
                               base.info_["final_objective"], rtol=1e-6)
    assert "_fused_xty" not in streamed.__dict__


def test_streaming_is_for_single_device_cuda_fits_above_a_chunk():
    model = FlashDeconv(device="cpu")
    assert not model._streams_xty(10 ** 7)
    model.device = torch.device("cuda")  # the rule only; nothing runs
    assert model._streams_xty(tnative.XTY_STREAM_CHUNK_ROWS + 1)
    assert not model._streams_xty(tnative.XTY_STREAM_CHUNK_ROWS)
    model.n_shards = 2
    assert not model._streams_xty(10 ** 7)


# -- FlashDeconv's device outputs ---------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    return make_synthetic(n_spots=400, n_genes=600, n_types=8, seed=0)


@pytest.fixture(scope="module")
def host_fit(small):
    Y, X, coords, _ = small
    return FlashDeconv(device="cpu", device_outputs=False, **FIT).fit(
        Y, X, coords)


def _dominant_agrees(got, props, gap=1e-5, gaps_of=None):
    """``got`` is props' argmax wherever the top two of ``gaps_of``
    (``props`` by default) differ by more than ``gap``."""
    top2 = np.sort(props if gaps_of is None else gaps_of, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > gap
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], np.argmax(props, 1)[clear])


def test_device_outputs_match_the_host_path_and_jax(small, host_fit):
    Y, X, coords, _ = small
    dev = FlashDeconv(device="cpu", device_outputs=True, **FIT).fit(
        Y, X, coords)
    assert dev._beta_host is None and isinstance(dev._beta_dev,
                                                 torch.Tensor)
    assert dev.proportions_.dtype == np.float64
    np.testing.assert_allclose(dev.proportions_, host_fit.proportions_,
                               atol=1e-6)
    np.testing.assert_allclose(dev.proportions_.sum(axis=1), 1.0,
                               atol=1e-5)
    assert dev.dominant_ is None
    ref = flashdeconv_tpu.FlashDeconv(device_outputs=True, **FIT).fit(
        Y, X, coords)
    assert dev.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(dev.proportions_, ref.proportions_,
                               atol=1e-5)
    # the lazy beta_: fetched once, cached, the device tensor released
    b = dev.beta_
    assert dev._beta_host is b and dev._beta_dev is None
    assert b.dtype == np.float64
    np.testing.assert_allclose(b, host_fit.beta_, atol=1e-6)
    np.testing.assert_allclose(b, ref.beta_, atol=1e-5)
    assert dev.get_abundances() is b


def test_auto_device_outputs_is_the_host_path_on_the_cpu(host_fit):
    assert host_fit._device_out() is False
    assert FlashDeconv(device="cpu")._device_out() is False
    assert FlashDeconv(device="cpu", n_shards=2,
                       device_outputs=True)._device_out() is True


@pytest.mark.parametrize("fetch_dtype", ["float16", "bfloat16", "float32"])
def test_fetch_dtype_casts_on_the_device(small, host_fit, fetch_dtype):
    """The proportions cross in ``fetch_dtype`` and come back f64: f16
    within 5e-4 of the exact ones (the JAX package's bound); bf16 (8 bits
    of mantissa) within 4e-3; f32 exactly the default device path. Against
    the JAX fit with the same ``fetch_dtype`` within one unit of the
    narrow type's rounding. The dominant type is the exact one wherever
    the narrowed top two differ (rounding is monotonic; bf16 makes ties
    that f32 does not have)."""
    Y, X, coords, _ = small
    got = FlashDeconv(device="cpu", device_outputs=True,
                      fetch_dtype=fetch_dtype, **FIT).fit(Y, X, coords)
    exact = FlashDeconv(device="cpu", device_outputs=True, **FIT).fit(
        Y, X, coords)
    assert got.proportions_.dtype == np.float64
    atol = {"float16": 5e-4, "bfloat16": 4e-3, "float32": 0.0}[fetch_dtype]
    np.testing.assert_allclose(got.proportions_, exact.proportions_,
                               atol=atol, rtol=0)
    np.testing.assert_allclose(got.proportions_, host_fit.proportions_,
                               atol=atol + 1e-6)
    ref = flashdeconv_tpu.FlashDeconv(device_outputs=True,
                                      fetch_dtype=fetch_dtype, **FIT).fit(
        Y, X, coords)
    np.testing.assert_allclose(got.proportions_, ref.proportions_,
                               atol=max(atol, 1e-5))
    _dominant_agrees(got.get_dominant_cell_type(), exact.proportions_,
                     gap=0.0, gaps_of=got.proportions_)


def test_outputs_dominant_only(small, host_fit):
    """Only the argmax (uint8 on the wire, int64 here) is fetched; the
    proportions stay on the device until read, then come back as the full
    proportions."""
    Y, X, coords, _ = small
    dom = FlashDeconv(device="cpu", device_outputs=True,
                      outputs=("dominant",), **FIT).fit(Y, X, coords)
    assert dom.dominant_.dtype == np.int64
    assert dom.dominant_.shape == (400,)
    assert dom._props_host is None and dom._props_dev is not None
    ref = flashdeconv_tpu.FlashDeconv(device_outputs=True,
                                      outputs=("dominant",), **FIT).fit(
        Y, X, coords)
    _dominant_agrees(dom.get_dominant_cell_type(), host_fit.proportions_)
    _dominant_agrees(ref.get_dominant_cell_type(), host_fit.proportions_)
    np.testing.assert_allclose(dom.proportions_, host_fit.proportions_,
                               atol=1e-6)
    assert dom._props_dev is None


def test_outputs_both_agree_with_each_other(small):
    Y, X, coords, _ = small
    m = FlashDeconv(device="cpu", device_outputs=True,
                    outputs=("proportions", "dominant"), **FIT).fit(
        Y, X, coords)
    assert m.dominant_ is not None and m._props_host is not None
    np.testing.assert_array_equal(m.dominant_,
                                  np.argmax(m.proportions_, axis=1))


def test_lazy_proportions_honour_fetch_dtype(small):
    Y, X, coords, _ = small
    m = FlashDeconv(device="cpu", device_outputs=True, fetch_dtype="float16",
                    outputs=("dominant",), **FIT).fit(Y, X, coords)
    assert m._props_dev.dtype == torch.float32
    want = m._props_dev.half().double().numpy()
    np.testing.assert_array_equal(m.proportions_, want)


def test_host_path_ignores_the_payload_controls(small, host_fit):
    Y, X, coords, _ = small
    m = FlashDeconv(device="cpu", device_outputs=False,
                    fetch_dtype="float16", outputs=("dominant",), **FIT).fit(
        Y, X, coords)
    assert m.dominant_ is None and m._props_host is not None
    np.testing.assert_array_equal(m.proportions_, host_fit.proportions_)


def test_device_outputs_on_a_mesh(small, host_fit):
    """An explicit ``device_outputs=True`` is honoured on a 2-shard CPU
    mesh: beta stays on the mesh until read; within 1e-6 of the host
    path's sharded fit, and of JAX's sharded device-output fit to 1e-5."""
    Y, X, coords, _ = small
    host = FlashDeconv(device="cpu", n_shards=2, device_outputs=False,
                       **FIT).fit(Y, X, coords)
    dev = FlashDeconv(device="cpu", n_shards=2, device_outputs=True,
                      **FIT).fit(Y, X, coords)
    assert dev._beta_host is None and dev._beta_dev is not None
    np.testing.assert_allclose(dev.proportions_, host.proportions_,
                               atol=1e-6)
    np.testing.assert_allclose(dev.beta_, host.beta_, atol=1e-6)
    ref = flashdeconv_tpu.FlashDeconv(n_shards=2, device_outputs=True,
                                      **FIT).fit(Y, X, coords)
    np.testing.assert_allclose(dev.proportions_, ref.proportions_,
                               atol=1e-5)
    assert dev.info_["n_shards"] == 2
