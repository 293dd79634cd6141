"""The yardstick of the benchmarked configurations does not move when the
reference or the counter learns another family. For `affine_nz64` and
`cmr_nz18`, at their published widths on the published pyramid:
`param_spec`'s ordered (name, shape, init), a digest of the weights
`weights.make` draws from it on the CPU at two seeds, and the operation
counts of a train step at the train cell's batch and of a batch-32
generation; at their toy widths on the icosphere, the reference's first
three steps (each step's losses, the first gradient's and the change's
norm per leaf). All equal the snapshot in `data/yardstick.json`.

The snapshot was written from the tree before the reference covered the
residual and conditioned encoders, with

    python -m bench_port.tests.test_bench_yardstick

and is rewritten only where a benchmark change means the yardstick to
move."""

import contextlib
import hashlib
import json
import os
import sys

import pytest
import torch

from bench_port import common, flops, train_cell, weights
from bench_port.reference import model as ref
from bench_port.reference.mesh import load_raw
from bench_port.tests import toy

SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "yardstick.json")
SEEDS = (toy.SEED, 3)
# the configurations the snapshot holds: their train cell's batch, and
# their toy widths
CONFIGS = {"affine_nz64": (32, toy.TOY_AFFINE), "cmr_nz18": (16, toy.TOY_CMR)}


@contextlib.contextmanager
def _one_thread():
    """torch's CPU erfinv rounds an element of a large tensor by a float32
    ulp differently where the threads' chunks split its vectorized loop
    (CUDA computes each element alike); one thread draws alike every time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _digest(spec: dict, seed: int) -> str:
    """sha256 of the weights' names and float32 bytes."""
    with _one_thread():
        w = weights.make(spec, seed, "cpu")
    h = hashlib.sha256()
    for name, t in w.items():
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _toy_reference_steps(name: str, widths: dict) -> dict:
    cf = toy.with_settings(toy.config(name, widths))
    mix = toy.TRAIN_MIX
    _, raw_of = train_cell.meshes(cf, train_cell.program_config(cf, mix, toy.SEED, "toy"))
    with _one_thread():
        return train_cell.reference_steps(cf, mix, toy.SEED, "cpu", raw_of())


def snapshot(name: str, raw: dict) -> dict:
    batch, widths = CONFIGS[name]
    s = common.config_file(common.benchmark(toy.REPO), name, toy.REPO)["settings"]
    spec = ref.param_spec(s, [a.shape[0] for a in raw["A"]], [a.shape[0] for a in raw["A_d"]])
    counter = flops.Counter(s, raw)
    return {"spec": [[n, list(shape), init] for n, (shape, init) in spec.items()],
            "weights": {str(seed): _digest(spec, seed) for seed in SEEDS},
            "train_batch": batch, "train_step": counter.train_step(batch),
            "decode_call": counter.decode_call(32),
            "toy_reference_steps": _toy_reference_steps(name, widths)}


@pytest.fixture(scope="module")
def raw():
    return load_raw(os.path.join(toy.REPO, "assets"))


@pytest.fixture(scope="module")
def frozen():
    with open(SNAPSHOT) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_yardstick_did_not_move(name, raw, frozen):
    assert snapshot(name, raw) == frozen[name]


if __name__ == "__main__":
    sys.path.insert(0, toy.REPO)
    loaded = load_raw(os.path.join(toy.REPO, "assets"))
    os.makedirs(os.path.dirname(SNAPSHOT), exist_ok=True)
    with open(SNAPSHOT, "w") as f:
        json.dump({n: snapshot(n, loaded) for n in CONFIGS}, f, indent=1)
        f.write("\n")
