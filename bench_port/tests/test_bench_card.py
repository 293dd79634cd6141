"""On the card: every cell runs and is correct, at a train cell's own
size the control fails the check while the program passes it, and
configs/default_config.yaml at its published widths is read for the
limits of a cell to come."""

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


# three seeds of default_config.yaml's readings (PERF.md)
DEFAULT_SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
def test_default_config_readings(card, tmp_path):
    """configs/default_config.yaml at its published widths, at its batch
    16, in float32, put in a temporary copy of the benchmark (never in
    BENCHMARK.json) beside cmr_nz18's train mix: calibrate.py's readings
    of the program against the reference over steps 0-2, of the bf16
    control and of the half-batch fault, on three seeds each, printed
    with the card. Every sound run's grad_gap (step 0's clipped gradient)
    lies below every control's; loss_gap and delta_gap are recorded, not
    asserted: the configuration's first steps are ill-conditioned."""
    from bench_port import common

    root = toy.root(str(tmp_path))
    os.symlink(os.path.join(toy.REPO, "assets"), os.path.join(root, "assets"))
    with open(os.path.join(root, "bench_port", "configs", "default_nz18.json"), "w") as f:
        json.dump(toy.default_config(None), f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "default_nz18", "source": "test",
                             "file": "bench_port/configs/default_nz18.json", "reduced": [],
                             "why": "test"})
    cell = "default_nz18.train.f32b16"
    bench["workloads"].append({"name": cell, "config": "default_nz18",
                               "traffic": "train.f32b16", "chips": 1, "why": "test"})
    with open(path, "w") as f:
        json.dump(bench, f)
    proc = subprocess.run(
        [toy.python(), "bench_port/calibrate.py", "--workload", cell,
         "--seeds", ",".join(map(str, DEFAULT_SEEDS)), "--controls", str(len(DEFAULT_SEEDS))],
        cwd=root, capture_output=True, text=True, timeout=2400, env=toy.env(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    readings = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    print(f"card: {common.power_limit()}")
    for r in readings:
        print(f"{cell} {json.dumps(r)}")
    grad = lambda kind: [r["grad_gap"] for r in readings if r["reading"] == kind]
    assert len(grad("program")) == len(grad("control_bf16")) == len(DEFAULT_SEEDS)
    assert max(grad("program")) < min(grad("control_bf16")), readings
