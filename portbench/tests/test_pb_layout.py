"""The benchmark is driven by data: every name in ``BENCHMARK.json``
resolves to its files, and new files plus a new entry add a configuration,
a traffic mix, a cell and a metric without editing a file."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import REPO, copy_benchmark

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = harness.Cell(cell)
    assert c.config["name"] == c.entry["config"]
    for fn in ("build", "setup", "run_one", "reference", "as_call",
               "compare"):
        assert callable(getattr(c.loop, fn))
    assert c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2
    for m in c.end_to_end + c.per_layer:
        assert callable(c.readers[m["name"]].read)
    assert set(c.limits) >= {"sweeps_off"}


def test_names_units_and_keys_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for c in SPEC["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and cfg["assumed"]
    assert (REPO / SPEC["configs"][0]["file"]).is_relative_to(
        REPO / SPEC["paths"][0])


def test_a_new_config_traffic_cell_and_metric_need_no_edit(tmp_path):
    root = copy_benchmark(tmp_path, tiny=False)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs/stereoseq_bin20_k20.json").read_text())
    cfg["name"] = "newchip_k20"
    (pb / "configs/newchip_k20.json").write_text(json.dumps(cfg))
    (pb / "traffic/solve_warm.json").write_text(json.dumps(
        dict(loop="solve", arrivals="closed loop", lambda_factor=[1.0, 1.0])))
    (pb / "limits/newchip_k20.solve_warm.json").write_text(
        json.dumps({"beta_gap": 1e-5, "sweeps_off": 0}))
    (pb / "metrics/solve.calls.py").write_text(
        "def read(run):\n    return float(len(run['records']))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="newchip_k20",
                                file="portbench/configs/newchip_k20.json"))
    spec["workloads"].append(dict(name="newchip_k20.solve_warm",
                                  config="newchip_k20", traffic="solve_warm",
                                  chips=1, why="a new cell"))
    spec["per_layer"].append(dict(
        name="solve.calls", unit="calls", better="higher",
        source="program_counter", layer="solve loop",
        moves="solve_spots_per_s", workloads=["newchip_k20.solve_warm"]))
    spec["end_to_end"][0]["workloads"].append("newchip_k20.solve_warm")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    c = harness.Cell("newchip_k20.solve_warm", root=root)
    assert c.config["name"] == "newchip_k20"
    assert "solve.calls" in c.readers
    assert c.readers["solve.calls"].read(dict(records=[{}, {}])) == 2.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         SPEC["workloads"][0]["name"], "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr
