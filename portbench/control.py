"""The readings behind each limit of the correctness check, on the chip.

``python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--control]``
makes each seed's inputs and runs the program's timed call once (set-up,
warm-up and the call itself as a run makes them), then the plain
reference; it prints the compared numbers of the program (the lower
readings). With ``--control`` it also runs the reference in TF32 (the
precision below the configurations' float32 with TF32 off) in the
program's place and prints its numbers (the upper readings). One JSON line
a seed on standard output. Benchmark runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness


def readings(cell: harness.Cell, seed: int, control: bool, device="cuda",
             log=harness.log) -> dict:
    loop = cell.loop
    if torch.device(device).type == "cuda":
        loop.build(log)
    state = loop.setup(cell.config, cell.traffic, seed, device, log)
    rec = loop.run_one(state)
    samples = [harness.to_host(rec.pop("output"))]
    harness.release(state, device)
    ref = loop.reference(state, samples, device, "f64", log)
    line = dict(workload=cell.name, seed=seed, sweeps=rec["sweeps"],
                program=loop.compare(ref, samples, [rec]))
    if control:
        ctl_recs, ctl_outs = loop.as_call(
            loop.reference(state, samples, device, "tf32", log), samples)
        line["control"] = loop.compare(ref, ctl_outs, ctl_recs)
    line["limits"] = cell.limits
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA card: no readings")
        return 2
    cell = harness.Cell(args.workload)
    for s in args.seeds.split(","):
        t = time.perf_counter()
        line = readings(cell, int(s), args.control)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
