"""Pytest hooks for the benchmark's tests in `tests/` (whose own
`conftest.py` holds the `card` fixture).

`tests/toy.py` `root()` renames the cells in each metric's `workloads` to
its toy cells through a dict of the benchmark's first three cells, and
would raise on any cell added since. Here it reads a copy of
BENCHMARK.json in which each cell is named by the one of those cells
whose mix has the same kind, so that every train cell maps to `toy.train`
and every serve cell to `toy.serve`, whatever cells the benchmark gains.
Once `toy.root` maps cells by their mix's kind itself, this file goes.
"""

import json
import os
import tempfile

from bench_port import common
from bench_port.tests import toy

# a cell of each mix kind that toy.root's dict knows
KNOWN = {"train": "cmr_nz18.train.f32b16", "serve": "affine_nz64.serve.sample_mix"}
_toy_root = toy.root


def by_kind(bench: dict) -> dict:
    """`bench` with the cells in each metric's `workloads` named by
    KNOWN's cell of their mix's kind."""
    kind = {w["name"]: common.traffic_file(w["traffic"], toy.BENCH_DIR)["kind"]
            for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({KNOWN[kind[w]] for w in m["workloads"]})
    return bench


def root(tmp: str) -> str:
    """`toy.root(tmp)`, reading the repository's BENCHMARK.json through
    `by_kind`."""
    with tempfile.TemporaryDirectory() as src:
        with open(os.path.join(src, "BENCHMARK.json"), "w") as f:
            json.dump(by_kind(common.benchmark(toy.REPO)), f)
        repo, toy.REPO = toy.REPO, src
        try:
            return _toy_root(tmp)
        finally:
            toy.REPO = repo


toy.root = root
