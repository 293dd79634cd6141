"""Toy cells for the benchmark's CPU tests: the flagship's family cut to
4 layers and narrow widths on a 258-vertex icosphere (`toy_mesh`), written
into a temporary copy of `bench_port` with a `BENCHMARK.json` of its own.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys
import types

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
SEED = 2 ** 31 + 77

TOY_AFFINE = {"num_conv_layers": 4, "nf": 8, "nz": 8, "nz_cond": 8, "nz_cond2": 4, "reduce_dim": 4}
# group norms of more than one channel wherever conditions enter (C > 32)
TOY_CMR = {"num_conv_layers": 4, "nf": 32, "nz": 8, "nz_cond": 24, "nz_cond2": 8, "reduce_dim": 8,
           "affine": 0}
TRAIN_MIX = {"kind": "train", "compute_dtype": "float32", "batch_size": 4, "n_train": 64,
             "steps_per_dispatch": 2, "profile_steps": 1, "rank": 4, "noise": 0.1,
             "pose_std": 0.3, "chunk": 16}
SERVE_MIX = {"kind": "serve", "compute_dtype": "float32", "batch_size": 4, "rate": 6.0,
             "sizes": {"1": 0.6, "4": 0.4}, "pose_std": 0.3, "warmup_requests": 4,
             "profile_seconds": 1, "tail_seconds": 30, "check": {"4": 2, "1": 3}}


def _limits(mix: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{mix}.json")) as f:
        return json.load(f)["limits"]


TRAIN_MIX["limits"] = _limits("train.f32b32")
SERVE_MIX["limits"] = _limits("serve.sample_mix")


def config(base: str = "affine_nz64", widths: dict = TOY_AFFINE) -> dict:
    """A configuration file's contents at toy widths on the icosphere."""
    with open(os.path.join(BENCH_DIR, "configs", f"{base}.json")) as f:
        cf = json.load(f)
    cf["preset"] = {**cf["preset"], **widths}
    cf["toy_mesh"] = 3
    return cf


def with_settings(cf: dict) -> dict:
    return {**cf, "settings": {**cf["defaults"], **cf["preset"]}}


def root(tmp: str) -> str:
    """A checkout-like directory: a copy of bench_port with the toy
    configuration ("toy"), mixes ("train.toy", "serve.toy") and cells
    ("toy.train", "toy.serve") in its BENCHMARK.json."""
    shutil.copytree(BENCH_DIR, os.path.join(tmp, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bp = os.path.join(tmp, "bench_port")
    for name, obj in (("configs/toy.json", config()), ("traffic/train.toy.json", TRAIN_MIX),
                      ("traffic/serve.toy.json", SERVE_MIX)):
        with open(os.path.join(bp, name), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        real = json.load(f)
    bench = copy.deepcopy(real)
    bench["configs"] = [{"name": "toy", "source": "test", "file": "bench_port/configs/toy.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [
        {"name": "toy.train", "config": "toy", "traffic": "train.toy", "chips": 1, "why": "t"},
        {"name": "toy.serve", "config": "toy", "traffic": "serve.toy", "chips": 1, "why": "t"}]
    rename = {"affine_nz64.train.f32b32": "toy.train", "cmr_nz18.train.f32b16": "toy.train",
              "affine_nz64.serve.sample_mix": "toy.serve"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({rename[w] for w in m["workloads"]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def args(seconds: float = 0.5, trace: int = 0, seed: int = SEED):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)


def env(root_dir: str) -> dict:
    """A subprocess environment that finds `bench_port` in `root_dir` first
    and the program in the repository."""
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join([root_dir, REPO] + [p for p in [e.get("PYTHONPATH")] if p])
    e["OMP_NUM_THREADS"] = "2"
    return e


def python() -> str:
    return sys.executable
