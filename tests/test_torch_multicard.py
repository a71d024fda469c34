"""The port on several cards: every kernel launches on the card that holds
its operands, and what moves between the cards of a mesh is ordered on
the streams that own it.

On the CPU (no card): each of the three kernel wrappers, given operands
that report ``cuda:1`` (CPU tensors behind a stand-in), launches through
``ops/_build.launch_stream``, which makes ``cuda:1`` current for the launch
and hands the kernel ``cuda:1``'s current stream, with ``torch.cuda.device``,
``torch.cuda.current_stream`` and the kernel library replaced by fakes
that record what was current at the launch; operands on two cards raise.
``Mesh.copy`` is held to the queue it must make, on fake streams: the
plain copy on the destination shard's stream on one card, and between two
cards the copy on the source shard's halo-copy stream between the waits
on the source's and the destination's streams; ``fork`` / ``join`` also
order each other card's current stream. A CPU mesh's banded and halo
solves move every tensor between shards through ``Mesh.copy``, bitwise as
before.

On a machine with two cards or more (marker ``cuda``; ``python -m pytest
tests/test_torch_multicard.py -m cuda --noconftest``: this file imports
no JAX, and tests/conftest.py does), each check is bitwise against one
card: single-device fused and gather solves and the dense sketch on
``cuda:1`` with ``cuda:0`` current, ``FlashDeconv(device="cuda:1")`` fits
of sparse and dense counts, the banded mesh (fused split and
unsplit, and unfused) and the halo plan on two cards against one card's
two shards. The card count is read inside a fixture, so every pytest
worker collects the same tests.
"""

import collections
import contextlib
import inspect
import types

import numpy as np
import pytest
import torch

from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.ops import _build
from flashdeconv_tpu_torch.ops import bcd as tbcd
from flashdeconv_tpu_torch.ops import countsketch as tcs
from flashdeconv_tpu_torch.parallel import _runner, gspmd
from flashdeconv_tpu_torch.parallel import solver as tpsolver
from flashdeconv_tpu_torch.utils.graph import build_knn_graph, grid_coords
from torch_problems import fused_problem, gather_problem


# -- fakes of the card ----------------------------------------------------------

class OnCard:
    """A CPU tensor that reports ``cuda:index``: the wrappers read only its
    shape, dtype, device, contiguity and pointer before the launch."""

    def __init__(self, t: torch.Tensor, index: int = 1):
        self.t = t.contiguous()
        self.device = torch.device("cuda", index)
        self.shape, self.dtype = self.t.shape, self.t.dtype

    def dim(self):
        return self.t.dim()

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.t.data_ptr()

    def new_empty(self, shape):
        return torch.zeros(shape, dtype=self.dtype)


class FakeCuda:
    """``torch.cuda.device`` / ``stream`` / ``current_stream`` / ``Stream``
    over a current card and a current stream per card, logging every wait
    and record."""

    def __init__(self):
        self.current = 0
        self.streams = {}
        self.log = []

    def stream_on(self, index, name):
        return types.SimpleNamespace(
            device=torch.device("cuda", index), name=name,
            cuda_stream=1000 * (index + 1) + len(name),
            wait_stream=lambda other, me=name: self.log.append(
                ("wait", me, other.name)),
            wait_event=lambda event, me=name: self.log.append(
                ("wait_event", me, event)),
            record_event=lambda me=name: self.log.append(
                ("record", me)) or f"event@{me}")

    def current_stream(self, device=None):
        index = self.current if device is None else torch.device(
            device).index
        if index not in self.streams:
            self.streams[index] = self.stream_on(index, f"current{index}")
        return self.streams[index]

    @contextlib.contextmanager
    def device(self, device):
        prev, self.current = self.current, torch.device(device).index
        try:
            yield
        finally:
            self.current = prev

    @contextlib.contextmanager
    def stream(self, stream):
        index = stream.device.index
        prev = (self.current, self.current_stream(stream.device))
        self.current, self.streams[index] = index, stream
        try:
            yield
        finally:
            self.current, self.streams[index] = prev

    def Stream(self, device):
        index = torch.device(device).index
        made = sum(1 for e in self.log if e[0] == "made")
        self.log.append(("made", made))
        return self.stream_on(index, f"mesh{made}@{index}")

    def install(self, monkeypatch):
        for name in ("device", "stream", "current_stream", "Stream"):
            monkeypatch.setattr(torch.cuda, name, getattr(self, name))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        return self


class FakeLib:
    """The three kernel libraries: each launch records the current card
    and the stream it was given, and succeeds."""

    def __init__(self, cuda: FakeCuda):
        self.cuda, self.launches = cuda, []

    def _launch(self, *args):
        self.launches.append((self.cuda.current, args[-1]))
        return 0

    fdt_fused_banded_sweep = fdt_cd_block_sweep = _launch
    fdt_countsketch_project = _launch

    def fdt_fused_banded_sweep_blocks(self, n_cols, K):
        return 3

    fdt_cd_block_sweep_blocks = fdt_fused_banded_sweep_blocks

    def fdt_countsketch_gene_tile(self):
        return 256


@pytest.fixture
def fake_card(monkeypatch):
    """Fakes of the card and of the kernel libraries, and a spy on
    ``launch_stream`` that records the devices of every launch's
    operands."""
    cuda = FakeCuda().install(monkeypatch)
    lib = FakeLib(cuda)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    helper, through = _build.launch_stream, []

    def spy(*operands):
        through.append({t.device for t in operands if t is not None})
        return helper(*operands)

    monkeypatch.setattr(_build, "launch_stream", spy)
    return types.SimpleNamespace(cuda=cuda, lib=lib, through=through)


def _fused_args(K=6, rest=False):
    p = fused_problem(n_types=K, seed=K)
    args = [OnCard(torch.from_numpy(p[k])) for k in
            ("carry", "Xty_t", "XtX", "masks")]
    args.append(OnCard(torch.ones_like(torch.from_numpy(p["Xty_t"]))))
    kw = {"out": OnCard(torch.zeros_like(torch.from_numpy(p["carry"])))}
    if rest:
        kw["ns_rest_t"] = OnCard(torch.zeros_like(args[1].t))
    return p, (*args, 0.5, 0.1, p["offsets"], p["h"], p["block"]), kw


def _fused(form):
    p, args, kw = _fused_args(40 if form == "large_k" else 6,
                              rest=form == "rest")
    if form == "sub":
        kw["sub"] = (1, 1, 2)
    return lambda: tbcd.fused_banded_sweep(*args, **kw)


def _cd():
    rng = np.random.RandomState(0)
    bt, xt, ns, inv = (OnCard(torch.from_numpy(np.abs(rng.randn(6, 300))
                                               .astype(np.float32)))
                       for _ in range(4))
    XtX = OnCard(torch.eye(6))
    out = OnCard(torch.zeros(6, 300))
    return lambda: tbcd.coordinate_descent_block(bt, xt, XtX, ns, inv, 0.5,
                                                 0.1, out=out)


def _countsketch(monkeypatch):
    n, g, d = 1024, 4100, 64
    Y = OnCard(torch.ones(n, g))
    buckets = OnCard(torch.zeros(g, dtype=torch.int32))
    weights = OnCard(torch.ones(g))
    out = OnCard(torch.zeros(n, d))
    plan = (OnCard(torch.zeros(g, dtype=torch.int32)), OnCard(torch.ones(g)),
            OnCard(torch.zeros(17 * d + 1, dtype=torch.int32)))
    monkeypatch.setattr(tcs, "gene_plan", lambda *a: plan)
    return lambda: tcs.countsketch_project_kernel(Y, buckets, weights, d,
                                                  out=out)


WRAPPERS = {
    "fused_banded_sweep": (lambda mp: _fused("whole"), tbcd.fused_banded_sweep,
                           "launches"),
    "fused_banded_sweep_large_k": (lambda mp: _fused("large_k"),
                                   tbcd.fused_banded_sweep,
                                   "large_k_launches"),
    "fused_banded_sweep_sub": (lambda mp: _fused("sub"),
                               tbcd.fused_banded_sweep, "sub_launches"),
    "fused_banded_sweep_rest": (lambda mp: _fused("rest"),
                                tbcd.fused_banded_sweep, "rest_launches"),
    "coordinate_descent_block": (lambda mp: _cd(),
                                 tbcd.coordinate_descent_block, "launches"),
    "countsketch_project": (_countsketch, tcs.countsketch_project_kernel,
                            "launches"),
}


# -- the launch helper (CPU) ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_launches_on_its_operands_card(fake_card, monkeypatch, name):
    """With cuda:0 current, a launch on operands on cuda:1 goes through
    ``launch_stream``, runs with cuda:1 current on cuda:1's current
    stream, leaves cuda:0 current, and counts once on cuda:1."""
    make, wrapper, attr = WRAPPERS[name]
    call = make(monkeypatch)
    before = getattr(wrapper, attr)
    cards = collections.Counter(wrapper.card_launches)
    call()
    stream1 = fake_card.cuda.current_stream(torch.device("cuda", 1))
    assert fake_card.through == [{torch.device("cuda", 1)}]
    assert fake_card.lib.launches == [(1, stream1.cuda_stream)]
    assert fake_card.cuda.current == 0
    assert getattr(wrapper, attr) == before + 1
    cards[1] += 1
    assert wrapper.card_launches == cards


def test_launch_stream_makes_the_card_current_and_restores(fake_card):
    a, b = OnCard(torch.zeros(3)), OnCard(torch.zeros(2))
    with _build.launch_stream(a, None, b) as stream:
        assert fake_card.cuda.current == 1
        assert stream == fake_card.cuda.current_stream(a.device).cuda_stream
    assert fake_card.cuda.current == 0


@pytest.mark.parametrize("devices", [(0, 1), (1, "cpu"), ("cpu",), ()])
def test_launch_stream_raises_off_one_card(fake_card, devices):
    operands = [torch.zeros(2) if d == "cpu" else OnCard(torch.zeros(2), d)
                for d in devices]
    with pytest.raises(ValueError):
        with _build.launch_stream(*operands):
            pass
    assert fake_card.cuda.current == 0


def test_wrapper_refuses_operands_on_two_cards(fake_card):
    p, args, kw = _fused_args()
    args = (args[0], OnCard(args[1].t, 0), *args[2:])
    with pytest.raises(ValueError, match="is on cuda:0"):
        tbcd.fused_banded_sweep(*args, **kw)
    assert fake_card.lib.launches == []


# -- Mesh.copy, fork and join (CPU) ---------------------------------------------

class Out:
    """A copy's destination that records what was current when it was
    written."""

    def __init__(self, cuda):
        self.cuda, self.seen = cuda, None

    def copy_(self, t):
        self.seen = (self.cuda.current,
                     {i: s.name for i, s in self.cuda.streams.items()})
        return self


def _waits(log):
    return [e for e in log if e[0] in ("wait", "wait_event", "record")]


def test_mesh_copy_on_one_card_is_the_plain_copy(monkeypatch):
    """Shards on one card: the copy is queued on the destination shard's
    halo-copy stream and nothing waits (the queue of a mesh of one
    card)."""
    cuda = FakeCuda().install(monkeypatch)
    mesh = _runner.Mesh(["cuda:0", "cuda:0"])
    mesh._ensure_streams()
    out = Out(cuda)
    del cuda.log[:]
    assert mesh.copy("t", 0, 1, out=out, side=True) is out
    assert out.seen == (0, {0: mesh._side[1].name})
    assert _waits(cuda.log) == []


def test_mesh_copy_between_cards_waits_on_the_owners(monkeypatch):
    """Shard 0 on cuda:0 to shard 1 on cuda:1: the copy runs on shard 0's
    halo-copy stream (cuda:0 current) after shard 0's stream, with shard
    1's halo-copy stream current on cuda:1 (ATen's barrier there), and
    shard 0's stream then waits for it."""
    cuda = FakeCuda().install(monkeypatch)
    mesh = _runner.Mesh(["cuda:0", "cuda:1"])
    mesh._ensure_streams()
    out = Out(cuda)
    del cuda.log[:]
    mesh.copy("t", 0, 1, out=out, side=True)
    copier, writer = mesh._side[0].name, mesh._streams[0].name
    assert out.seen == (0, {0: copier, 1: mesh._side[1].name})
    assert _waits(cuda.log) == [("wait", copier, writer),
                                ("wait", writer, copier)]
    assert cuda.current == 0 and cuda.streams[1].name == "current1"


def test_mesh_copy_from_the_main_stream_to_another_card(monkeypatch):
    """``src`` None: the main device's current stream wrote the tensor;
    the main shard's halo-copy stream copies it to cuda:1's shard."""
    cuda = FakeCuda().install(monkeypatch)
    mesh = _runner.Mesh(["cuda:0", "cuda:1"])
    mesh._ensure_streams()
    t = OnCard(torch.zeros(2), 0)
    out = Out(cuda)
    del cuda.log[:]
    mesh.copy(t, None, 1, out=out)
    copier = mesh._side[0].name
    assert out.seen == (0, {0: copier, 1: mesh._streams[1].name})
    assert _waits(cuda.log) == [("wait", copier, "current0"),
                                ("wait", "current0", copier)]


@pytest.mark.parametrize("devices", [("cuda:0", "cuda:0"),
                                     ("cuda:0", "cuda:1")])
def test_fork_and_join_order_every_card(monkeypatch, devices):
    """Fork: every shard stream waits for the main device's current
    stream, and a shard on another card also for that card's; join: the
    main stream waits for every shard stream, that card's current stream
    for its shard's. On one card only the first of each."""
    cuda = FakeCuda().install(monkeypatch)
    mesh = _runner.Mesh(devices)
    mesh.fork()
    mesh.join()
    streams = [s.name for s in (*mesh._streams, *mesh._side)]
    fork = [("record", "current0")] + [("wait_event", s, "event@current0")
                                       for s in streams]
    join = [("wait", "current0", s) for s in streams]
    if devices[1] != devices[0]:
        fork += [("wait", mesh._streams[1].name, "current1"),
                 ("wait", mesh._side[1].name, "current1")]
        join += [("wait", "current1", mesh._streams[1].name),
                 ("wait", "current1", mesh._side[1].name)]
    assert _waits(cuda.log) == fork + join


def _sketch(coords, K=7, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(K, 48)
    Y = np.abs(rng.randn(coords.shape[0], K)) @ X \
        + 0.05 * rng.randn(coords.shape[0], 48)
    return Y, X, build_knn_graph(coords, k=6)


def test_cpu_mesh_moves_every_shard_tensor_through_mesh_copy(monkeypatch):
    """The pads of the fused banded mesh (split and unsplit), the windows
    of the unfused one, the halo plan's pools and every gather go through
    ``Mesh.copy``, and the solves give the same bits as before (the
    plain copy where the shards share a device)."""
    coords = grid_coords(side=64)
    Y, X, A = _sketch(coords)
    kw = dict(lambda_=0.3, rho=0.01, tol=1e-4, max_iter=20)
    mesh = ("cpu",) * 3
    runs = {}
    for spied in (False, True):
        callers = collections.Counter()
        if spied:
            real = _runner.Mesh.copy

            def spy(self, t, src, dst, out=None, side=False):
                callers[inspect.stack()[1].function] += 1
                return real(self, t, src, dst, out=out, side=side)

            monkeypatch.setattr(_runner.Mesh, "copy", spy)
        fused = gspmd.GspmdBandedProblem(Y, X, A, mesh=mesh, fused_block=256,
                                         device="cpu")
        unfused = gspmd.GspmdBandedProblem(Y, X, A, mesh=mesh, fused_block=1,
                                           device="cpu")
        assert fused.use_fused and not unfused.use_fused
        runs[spied] = [fused._run(kw["lambda_"], kw["rho"], kw["tol"],
                                  kw["max_iter"], overlap=o)[0].numpy()
                       for o in (False, True)]
        runs[spied].append(unfused.solve(**kw)[0])
        runs[spied].append(tpsolver.sharded_bcd_solve(
            Y, X, A, coords=coords, mesh=mesh, strategy="halo",
            device="cpu", **kw)[0])
        if spied:
            assert {"_refresh_pads", "_window_edges", "_halo_exchange",
                    "gather"} <= set(callers), callers
    for a, b in zip(runs[False], runs[True]):
        np.testing.assert_array_equal(a, b)


# -- on two cards (marker cuda) --------------------------------------------------

@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["FusedBandedTier", "GatherTier"])
def test_single_device_solve_on_the_second_card(two_cards, tier):
    """``prepare_bcd(..., device="cuda:1")`` solves with cuda:0 current,
    bitwise the same solve on cuda:0, and leaves cuda:0 current."""
    first, second = two_cards
    coords = (grid_coords(side=96) if tier == "FusedBandedTier"
              else gather_problem(n=5000, n_types=12, seed=6)["coords"])
    Y, X, A = _sketch(coords, K=12)
    out = {}
    for dev in (first, second):
        prob = tsolver.prepare_bcd(Y, X, A, coords=coords, device=dev)
        assert type(prob.tier).__name__ == tier
        out[dev] = prob.solve(lambda_=0.3, max_iter=40)
        assert torch.cuda.current_device() == 0
    assert out[second][1]["n_iterations"] == out[first][1]["n_iterations"]
    np.testing.assert_array_equal(out[second][0], out[first][0])


@pytest.mark.cuda
def test_dense_sketch_on_the_second_card(two_cards):
    from flashdeconv_tpu_torch.core.sketching import make_countsketch_op

    rng = np.random.default_rng(0)
    Y = rng.random((2048, 4100), dtype=np.float32) * 6.0
    op = make_countsketch_op(4100, 256, rng.random(4100) + 0.1,
                             random_state=0)
    got = [tcs.countsketch_project_kernel(
        torch.from_numpy(Y).to(d), torch.from_numpy(op.buckets).to(d),
        torch.from_numpy(op.weights.astype(np.float32)).to(d), 256)
        for d in two_cards]
    assert torch.cuda.current_device() == 0
    assert torch.equal(got[1].cpu(), got[0].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [20, 96])
def test_banded_mesh_on_two_cards_is_bitwise_one_cards(two_cards, K):
    """The fused banded mesh on two cards, unsplit and split, over 200
    sweeps, and the unfused one (blocks of one spot: kernel #2 per shard),
    bitwise one card's two shards."""
    first, second = two_cards
    coords = grid_coords(side=96)
    Y, X, A = _sketch(coords, K=K, seed=K)
    one, two = [gspmd.GspmdBandedProblem(Y, X, A, mesh=mesh, fused_block=256)
                for mesh in ((first, first), (first, second))]
    assert one.use_fused and two.use_fused
    ref, it, _ = one._run(0.3, 0.01, 0.0, 200, overlap=False)
    for overlap in (False, True):
        beta, it2, _ = two._run(0.3, 0.01, 0.0, 200, overlap=overlap)
        assert it == it2 == 200
        assert torch.equal(beta.cpu(), ref.cpu())
    one, two = [gspmd.GspmdBandedProblem(Y, X, A, mesh=mesh, fused_block=1)
                for mesh in ((first, first), (first, second))]
    assert not two.use_fused
    a, b = one.solve(lambda_=0.3, max_iter=40), two.solve(lambda_=0.3,
                                                          max_iter=40)
    assert a[1]["n_iterations"] == b[1]["n_iterations"]
    np.testing.assert_array_equal(b[0], a[0])


@pytest.mark.cuda
def test_halo_plan_on_two_cards_is_bitwise_one_cards(two_cards):
    first, second = two_cards
    coords = gather_problem(n=5000, n_types=12, seed=6)["coords"]
    Y, X, A = _sketch(coords, K=12)
    a, b = [tpsolver.sharded_bcd_solve(Y, X, A, coords=coords, mesh=mesh,
                                       strategy="halo", lambda_=0.3)
            for mesh in ((first, first), (first, second))]
    assert torch.cuda.current_device() == 0
    assert a[1]["n_iterations"] == b[1]["n_iterations"]
    np.testing.assert_array_equal(b[0], a[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_fit_on_the_second_card(two_cards, dense):
    """``FlashDeconv(device="cuda:1")`` with cuda:0 current, device outputs
    on (the default of a single-device fit): bitwise the same fit on
    cuda:0; dense counts sketch through kernel #3 on cuda:1."""
    from scipy import sparse

    from flashdeconv_tpu_torch import FlashDeconv

    rng = np.random.default_rng(0)
    coords = grid_coords(side=96)
    n_genes = 5001 if dense else 600
    X = rng.gamma(2.0, 1.0, (6, n_genes))
    props = rng.dirichlet(np.ones(6), size=coords.shape[0])
    Y = rng.poisson(props @ X * 5.0).astype(np.float64)
    if not dense:
        Y = sparse.csr_matrix(Y)
    out = {}
    for dev in two_cards:
        before = tcs.countsketch_project_kernel.card_launches[dev.index]
        out[dev] = FlashDeconv(sketch_dim=64, n_hvg=n_genes,
                               device=dev).fit_transform(Y, X, coords)
        assert torch.cuda.current_device() == 0
        launched = (tcs.countsketch_project_kernel.card_launches[dev.index]
                    - before)
        assert launched == (1 if dense else 0)
    np.testing.assert_array_equal(out[two_cards[1]], out[two_cards[0]])
