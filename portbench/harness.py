"""Runs one cell of ``BENCHMARK.json`` once and prints the result line.

Everything a cell needs is found by name: its configuration through the
``configs`` entry of ``BENCHMARK.json``; its traffic mix in
``traffic/<traffic>.json``, whose ``loop`` names the general loop in
``loops/<loop>.py`` (``build``, ``setup``, ``run_one``, ``reference``,
``as_call``, ``compare``); the limits of its
correctness check in ``limits/<cell>.json``; and each metric's reader in
``metrics/<metric>.py`` (``read(run) -> float or None``). A new
configuration, mix, cell or metric is new files and a new entry; no file
here changes.

A run: set-up (the program's kernels built, or found built; inputs from
the seed, the program's prepare and one warm-up call), then a closed-loop
window of ``--seconds`` (calls start until the window's time is up; the
last one runs to its end), then, with the
program's state freed, the plain reference and the comparison that decides
``correct``. With ``--trace 1`` the window runs under ``torch.profiler``
and the line carries the per-layer metrics and the trace's breakdown.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that may not be loaded in a run, compared whole: the
#: JAX stack, the JAX package (a prefix of the port's name) and its
#: benchmark scripts.
BANNED_MODULES = ("jax", "jaxlib", "flax", "flashdeconv_tpu", "bench",
                  "benchmarks")
#: Outputs of timed calls kept for the check, drawn from the seed.
N_SAMPLES = 2


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "portbench_file_" + "".join(
        ch if ch.isalnum() else "_" for ch in f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def metric_applies(metric: dict, cell: str, e2e: Dict[str, dict]) -> bool:
    """A metric with ``workloads`` belongs to those cells; an end-to-end
    one without, to every cell; a per-layer one without, to every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric_applies(e2e[metric["moves"]], cell, e2e)
    return True


class Cell:
    """One cell of ``BENCHMARK.json`` with every file it names loaded."""

    def __init__(self, name: str, root: Path = ROOT):
        spec = load_json(root / "BENCHMARK.json")
        here = root / "portbench"
        self.name = name
        self.entry = by_name(spec["workloads"], name, "workload")
        cfg_entry = by_name(spec["configs"], self.entry["config"],
                            "configuration")
        self.config = load_json(root / cfg_entry["file"])
        self.traffic = load_json(here / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.loop_name = self.traffic["loop"]
        self.loop = load_module(here / "loops" / f"{self.loop_name}.py")
        self.limits = load_json(here / "limits" / f"{name}.json")
        e2e = {m["name"]: m for m in spec["end_to_end"]}
        self.end_to_end = [m for m in spec["end_to_end"]
                           if metric_applies(m, name, e2e)]
        self.per_layer = [m for m in spec["per_layer"]
                          if metric_applies(m, name, e2e)]
        self.readers = {m["name"]: load_module(
            here / "metrics" / f"{m['name']}.py")
            for m in self.end_to_end + self.per_layer}
        self.chips = int(self.entry["chips"])


def banned_loaded() -> List[str]:
    """Banned top-level modules in ``sys.modules`` (whole names)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED_MODULES))


def to_host(item):
    """``item`` with every tensor in it (in a dict, too) copied to the
    host."""
    import torch

    if isinstance(item, dict):
        return {k: to_host(v) for k, v in item.items()}
    return item.cpu() if torch.is_tensor(item) else item


def reservoir(samples: list, item, index: int, rng) -> None:
    """Keep a uniform sample of ``N_SAMPLES`` of the items seen so far, on
    the host, so that the kept outputs take no device memory from the
    window's peak."""
    if len(samples) < N_SAMPLES:
        samples.append(to_host(item))
        return
    j = int(rng.integers(0, index + 1))
    if j < N_SAMPLES:
        samples[j] = to_host(item)


def card_info(chips: int) -> dict:
    """The card's name, its power limit and the cards the run sees."""
    import torch

    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips, visible=torch.cuda.device_count())
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def finite(x: float) -> Optional[float]:
    return float(x) if math.isfinite(float(x)) else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             log: Callable[[str], None] = log) -> dict:
    """One run of ``cell``; returns the result line's fields."""
    import numpy as np
    import torch

    from portbench import inputs

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    loop = cell.loop
    log(f"start-up {time.perf_counter() - t_start:.3f} s")
    build_s = None
    if cuda:
        t = time.perf_counter()
        loop.build(log)
        build_s = time.perf_counter() - t
        log(f"kernels built or found in {build_s:.3f} s")
    state = loop.setup(cell.config, cell.traffic, seed, device, log)
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    rng = np.random.default_rng(inputs.stream_seed(seed,
                                                   inputs.STREAM_SAMPLE))
    records: List[dict] = []
    samples: list = []
    attempted = failed = 0
    span_name = f"portbench.{cell.loop_name}"
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)

    def span(name):
        if not trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    with (prof if prof is not None else contextlib.nullcontext()):
        with span("portbench.window"):
            t_open = time.perf_counter()
            deadline = t_open + seconds
            while time.perf_counter() < deadline:
                attempted += 1
                t0 = time.perf_counter()
                try:
                    with span(span_name):
                        rec = loop.run_one(state)
                        sync()
                except Exception:
                    failed += 1
                    log("a timed call failed:\n" + traceback.format_exc())
                    break
                rec["t0"], rec["t1"] = t0, time.perf_counter()
                reservoir(samples, rec.pop("output", None), len(records),
                          rng)
                records.append(rec)
    window_s = (records[-1]["t1"] if records else time.perf_counter()) - t_open
    window_peak = torch.cuda.max_memory_allocated() if cuda else None
    log(f"window {window_s:.3f} s, {len(records)} calls")
    if records:
        ms = np.array([(r["t1"] - r["t0"]) * 1e3 for r in records])
        q1, q2, q3 = np.percentile(ms, [25, 50, 75])
        sweeps = np.unique([r["sweeps"] for r in records], return_counts=True)
        log(f"calls ms: min {ms.min():.3f} q1 {q1:.3f} median {q2:.3f} q3 "
            f"{q3:.3f} max {ms.max():.3f}; sweeps "
            f"{dict(zip(sweeps[0].tolist(), sweeps[1].tolist()))}")

    summary = None
    if prof is not None:
        from portbench.tracing import reduce_profile

        t = time.perf_counter()
        summary = reduce_profile(prof)
        del prof
        log(f"trace reduced in {time.perf_counter() - t:.3f} s")

    run = dict(records=records, window_s=window_s,
               setup_s=setup_s, trace=summary, window_peak_bytes=window_peak,
               work=state["work"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])

    compared = check(cell, state, samples, records, device, log)
    limits = {k: float(cell.limits[k]) for k in compared}
    correct = (failed == 0 and bool(records) and bool(compared) and all(
        math.isfinite(v) and v <= limits[k] for k, v in compared.items()))

    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics)
    if cuda:
        result["device"] = dict(
            card_info(cell.chips),
            memory_peak_bytes=int(max(setup_peak, window_peak)))
    else:
        result["device"] = dict(platform="cpu", count=0)
    if summary:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"])
    # setup_s holds the build; in a fresh checkout build_s is nvcc's and
    # g++'s, in a built one the look for the libraries.
    result["setup"] = dict(build_s=build_s, tier=state.get("tier"))
    result["compared"] = {k: dict(value=finite(v), limit=limits[k])
                          for k, v in compared.items()}
    return result


def release(state: dict, device) -> None:
    """Drops the program's state (``state["program"]``) and returns its
    device memory, so that the reference runs after it."""
    import torch

    state.pop("program", None)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(cell: Cell, state: dict, samples: list, records: list, device,
          log) -> Dict[str, float]:
    """The compared numbers: the plain reference in float64, after the
    program's state is released, against the sampled outputs and every
    call's record."""
    release(state, device)
    ref = cell.loop.reference(state, samples, device, "f64", log)
    return cell.loop.compare(ref, samples, records)


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse_args(argv)
    import torch

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}: no result")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    found = banned_loaded()
    if found:
        log(f"modules that the run may not load are loaded: {found}")
        return 3
    for k, v in result["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
