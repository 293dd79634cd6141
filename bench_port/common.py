"""The harness's registry and its result line.

Everything a cell needs is found by name: the cell in `BENCHMARK.json` at
the checkout's root, its configuration's file (`configs/<config>.json`),
its traffic mix (`traffic/<mix>.json`, whose `kind` names the runner
`<kind>_cell.py` and the generator `traffic/<kind>.py`), and each
per-layer metric's reader (`metrics/<metric>.py`, a `read(m)` that returns
a number or None when the run gives it nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# what the harness writes while it runs: traces, the kernels' build
# caches it points the toolchains at (fixed paths inside the checkout)
WORK_DIR = os.path.join(ROOT, "build", "bench_port")
FORBIDDEN = ("jax", "jaxlib", "flax", "cape_tpu")
# fixed cores for the process that drives the card (a train run, the
# serve cell's server) and for the serve cell's load generator: on an
# 8-core H100 host, five 20 s train runs left to the scheduler spread 23%
# in rate, five pinned 4% (PERF.md)
PROGRAM_CORES = (2, 3)
CLIENT_CORES = (4, 5)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: str = ROOT) -> dict:
    """A configuration's file, with "settings": its preset over the
    published defaults the preset leaves out."""
    for c in bench["configs"]:
        if c["name"] == name:
            cfg = load_json(os.path.join(root, c["file"]))
            return {**cfg, "settings": {**cfg["defaults"], **cfg["preset"]}}
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The reader module of a per-layer metric."""
    return _load(os.path.join(bench_dir, "metrics", f"{metric}.py"),
                 "bench_port_metric_" + metric.replace(".", "_").replace("-", "_"))


def generator(kind: str, bench_dir: str = BENCH_DIR):
    """The traffic generator module of a mix kind."""
    return _load(os.path.join(bench_dir, "traffic", f"{kind}.py"), f"bench_port_traffic_{kind}")


def cell_metrics(bench: dict, name: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metrics the cell reports: those that list
    it, and those that list no cell (a per-layer one then wherever the
    end-to-end metric it moves is reported)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if name in m["workloads"] or ("workloads" not in m and m["moves"] in names)]
    return e2e, per


def read_per_layer(metrics: list[dict], m: dict, bench_dir: str = BENCH_DIR) -> dict:
    """{name: {value, unit}} of each per-layer metric whose reader finds
    something in the measurements `m`."""
    out = {}
    for spec in metrics:
        value = reader(spec["name"], bench_dir).read(m)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def pin(cores) -> bool:
    """Keep this process, and the threads and processes it starts, on
    `cores`; where it may not run on all of them it stays as it is."""
    if not hasattr(os, "sched_getaffinity") or not set(cores) <= os.sched_getaffinity(0):
        return False
    os.sched_setaffinity(0, cores)
    return True


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `cape_tpu_torch` is not `cape_tpu`)."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def quantile(values: list[float], q: float) -> float:
    """The nearest-rank q-quantile (inf counts as larger than any value)."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def power_limit() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def emit(result: dict, checks: dict) -> None:
    """Print every compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output,
    with the checks under its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
