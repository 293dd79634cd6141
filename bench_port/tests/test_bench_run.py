"""`run.py` refuses to run without a card, prints no result then, and
never falls back to the CPU; a checkout that holds only the benchmark's
files cannot run a cell either."""

import json
import os
import shutil
import subprocess

from bench_port.tests import toy


def _run(cwd, workload="affine_nz64.train.f32b32", env=None):
    return subprocess.run(
        [toy.python(), "bench_port/run.py", "--workload", workload, "--seed", str(toy.SEED),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_no_card_no_result():
    for wl in json.load(open(os.path.join(toy.REPO, "BENCHMARK.json")))["workloads"]:
        proc = _run(toy.REPO, wl["name"])
        assert proc.returncode != 0 and _no_result(proc), (wl["name"], proc.stdout)
        assert "CUDA card" in proc.stderr


def test_only_the_benchmark_files(tmp_path):
    """BENCHMARK.json and bench_port alone: the program is missing, so the
    run fails, with or without a card."""
    shutil.copy(os.path.join(toy.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(toy.REPO, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, env={"PYTHONPATH": ""})
    assert proc.returncode != 0 and _no_result(proc)
