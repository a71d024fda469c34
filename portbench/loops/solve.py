"""Cold re-solves of one prepared section over a lambda scan:
``BCDProblem.solve`` on the problem that ``prepare_bcd`` built once in
set-up, one after another, each at a lambda of its own.

Set-up makes the sketch-space problem from the seed on the card (Y (n, d),
X (K, d)), builds the kNN graph of the coordinates, prepares the problem
with the configuration's dtype, checks that it took the configuration's
tier, and solves it once to warm up. Each timed call is
``solve(return_device=True)`` with no ``beta_init``, the configuration's
rho, tol and max_iter, and a lambda drawn from the seed: the
configuration's lambda times a factor log-uniform over the mix's
``lambda_factor`` range, as a user's scan of the smoothing visits one
setting after another, and no two calls alike. The check solves each
sampled call's setting with the reference and compares its beta and its
sweeps.

``state["program"]`` holds the program's prepared problem; the harness
drops it before the reference runs.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import inputs
from portbench.reference import solve as ref_solve


def build(log) -> None:
    """Builds (in a fresh checkout) and loads the program's CUDA kernels."""
    from flashdeconv_tpu_torch.ops import _build

    _build.build()


def setup(cfg: dict, traffic: dict, seed: int, device, log) -> dict:
    from flashdeconv_tpu_torch.core.solver import prepare_bcd

    t = time.perf_counter()
    coords = inputs.layout_coords(cfg["layout"])
    if coords.shape[0] != int(cfg["n_bins"]):
        raise ValueError(f"layout gives {coords.shape[0]} bins, the "
                         f"configuration states {cfg['n_bins']}")
    A = inputs.knn_graph(coords, int(cfg["k_neighbors"]))
    Yd, Xd = inputs.sketch_problem(cfg, coords, seed, device)
    Y, X = Yd.cpu().numpy(), Xd.cpu().numpy()
    del Yd, Xd
    log(f"inputs: {coords.shape[0]} bins, {A.nnz} graph edges, Y "
        f"{Y.shape} {Y.dtype}, X {X.shape} in "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    prob = prepare_bcd(Y, X, A, coords=coords,
                       dtype=np.dtype(cfg["solve"]["dtype"]), device=device)
    _sync(device)
    tier = type(getattr(prob, "tier", None)).__name__
    log(f"prepare_bcd {time.perf_counter() - t:.3f} s, tier {tier}")
    if tier != cfg["tier"]:
        raise RuntimeError(f"the problem took the {tier}; the configuration "
                           f"measures the {cfg['tier']}")
    s = cfg["solve"]
    lo, hi = (math.log(float(f)) for f in traffic["lambda_factor"])
    state = dict(cfg=cfg, traffic=traffic, program=prob, Y=Y, X=X, A=A,
                 kw=dict(rho=float(s["rho"]), tol=float(s["tol"]),
                         max_iter=int(s["max_iter"])),
                 lambda_=float(s["lambda"]), log_factor=(lo, hi),
                 lambdas=np.random.default_rng(
                     inputs.stream_seed(seed, inputs.STREAM_LAMBDA)),
                 tier=tier,
                 work=dict(n_spots=coords.shape[0],
                           n_types=int(cfg["n_types"]), n_edges=int(A.nnz)))
    t = time.perf_counter()
    prob.solve(lambda_=state["lambda_"], return_device=True, **state["kw"])
    _sync(device)
    log(f"warm-up solve {time.perf_counter() - t:.3f} s")
    return state


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_one(state: dict) -> dict:
    lam = state["lambda_"] * math.exp(
        state["lambdas"].uniform(*state["log_factor"]))
    beta, info = state["program"].solve(lambda_=lam, return_device=True,
                                        **state["kw"])
    sweeps = int(info["n_iterations"])
    return dict(spots=state["work"]["n_spots"], sweeps=sweeps,
                output=dict(lambda_=lam, sweeps=sweeps, beta=beta))


def reference(state: dict, samples: list, device, precision: str, log):
    """The plain reference's solves of the same Y, X and graph, one at
    each sampled call's lambda."""
    t = time.perf_counter()
    X64 = state["X"].astype(np.float64)
    Xty = ref_solve.xty_from_sketch(state["Y"], state["X"], precision,
                                    device)
    XtX, kw = X64 @ X64.T, state["kw"]
    sols = [ref_solve.bcd(Xty, XtX, state["A"], s["lambda_"],
                          kw["rho"], kw["tol"], kw["max_iter"], precision)
            for s in samples]
    log(f"reference ({precision}) at lambda "
        f"{[round(s['lambda_'], 6) for s in samples]}: "
        f"{[sol.n_iterations for sol in sols]} sweeps in "
        f"{time.perf_counter() - t:.3f} s")
    return sols


def as_call(sols, samples: list):
    """The reference's solves in the place of the sampled calls: (records,
    outputs)."""
    outs = [dict(lambda_=s["lambda_"], sweeps=sol.n_iterations,
                 beta=sol.beta) for s, sol in zip(samples, sols)]
    return [dict(sweeps=o["sweeps"]) for o in outs], outs


def compare(sols, samples: list, records: list) -> dict:
    """``beta_gap``: max over the sampled solves of max|beta - beta_ref| /
    max|beta_ref| at the same lambda; ``sweeps_off``: the largest
    difference between a sampled solve's sweeps and the reference's."""
    inf = float("inf")
    pairs = list(zip(samples, sols))
    return dict(
        beta_gap=max((ref_solve.max_gap(s["beta"], sol.beta)
                      for s, sol in pairs), default=inf),
        sweeps_off=float(max((abs(s["sweeps"] - sol.n_iterations)
                              for s, sol in pairs), default=inf)),
    )
