"""On the card: every cell runs and is correct, and at a train cell's own
size the control fails the check while the program passes it."""

import json
import os
import subprocess

import pytest

from bench_port.tests import toy

CELLS = [w["name"] for w in json.load(open(os.path.join(toy.REPO, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    proc = subprocess.run(
        [toy.python(), "bench_port/run.py", "--workload", cell, "--seed", str(toy.SEED),
         "--seconds", "3", "--trace", "0"],
        cwd=toy.REPO, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    proc = subprocess.run(
        [toy.python(), "bench_port/calibrate.py", "--workload", "affine_nz64.train.f32b32",
         "--seeds", str(toy.SEED), "--controls", "1"],
        cwd=toy.REPO, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(toy.BENCH_DIR, "traffic", "train.f32b32.json")) as f:
        limits = json.load(f)["limits"]
    readings = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    for r in readings:
        failed = any(r[k] > limits[k] for k in limits)
        assert failed == (r["reading"] != "program"), r
