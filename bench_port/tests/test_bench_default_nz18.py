"""`default_nz18`, configs/default_config.yaml as the benchmark runs it:
its file is the preset verbatim over `cmr_nz18`'s defaults and settings,
as `toy.default_config` builds it; its yardstick does not move unseen; on
the card its readings hold to its cell's own limits.

The yardstick, as `test_bench_yardstick.py` takes it for the earlier
configurations: at the published widths on the published pyramid,
`param_spec`'s ordered (name, shape, init), a digest of the weights at
two seeds and the operation counts of a train step at batch 16 and of a
batch-32 generation; at `toy.TOY_DEFAULT` on the icosphere, the
reference's first three steps. All equal `data/yardstick_default_nz18.json`,
written with

    python -m bench_port.tests.test_bench_default_nz18
"""

import json
import math
import os
import subprocess
import sys

import pytest

from bench_port import common, flops
from bench_port.reference import model as ref
from bench_port.reference.mesh import load_raw
from bench_port.tests import test_bench_yardstick as yardstick
from bench_port.tests import toy

NAME, CELL, MIX = "default_nz18", "default_nz18.train.f32b16", "train.f32b16_klclamp"
BATCH = 16   # the cell's, default_config.yaml's own
SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "yardstick_default_nz18.json")


def snapshot(raw: dict) -> dict:
    """The yardstick's entry of default_nz18, in the form of
    `test_bench_yardstick.snapshot`'s."""
    s = common.config_file(common.benchmark(toy.REPO), NAME, toy.REPO)["settings"]
    spec = ref.param_spec(s, [a.shape[0] for a in raw["A"]], [a.shape[0] for a in raw["A_d"]])
    counter = flops.Counter(s, raw)
    return {"spec": [[n, list(shape), init] for n, (shape, init) in spec.items()],
            "weights": {str(seed): yardstick._digest(spec, seed) for seed in yardstick.SEEDS},
            "train_batch": BATCH, "train_step": counter.train_step(BATCH),
            "decode_call": counter.decode_call(32),
            "toy_reference_steps": yardstick._toy_reference_steps(NAME, toy.TOY_DEFAULT)}


@pytest.fixture(scope="module")
def raw():
    return load_raw(os.path.join(toy.REPO, "assets"))


def test_the_yardstick_did_not_move(raw):
    with open(SNAPSHOT) as f:
        assert snapshot(raw) == json.load(f)


def test_the_file_is_default_config_yaml(raw):
    """The preset verbatim over cmr_nz18's defaults (with CAPE's `affine:
    0` and `lr_warmup: 0`, which the preset leaves out) and deployment
    settings, uncut; its parameter count is param_spec's, the
    discriminator's included."""
    real = common.config_file(common.benchmark(toy.REPO), NAME, toy.REPO)
    built = toy.default_config(None)
    for key in ("name", "source", "preset_file", "preset", "defaults", "overrides", "reduced"):
        assert real[key] == built[key], key
    assert real["reduced"] == []
    spec = ref.param_spec(real["settings"], [a.shape[0] for a in raw["A"]],
                          [a.shape[0] for a in raw["A_d"]])
    assert real["parameters"] == sum(math.prod(shape) for shape, _ in spec.values())


def test_the_cells_mix_is_train_f32b16_under_its_own_limits():
    mine, base = common.traffic_file(MIX), common.traffic_file("train.f32b16")
    assert {k: v for k, v in mine.items() if k != "limits"} == \
        {k: v for k, v in base.items() if k != "limits"}
    assert mine["limits"].keys() == base["limits"].keys()
    wl = common.workload(common.benchmark(toy.REPO), CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (NAME, MIX, 1)


def test_the_toy_root_maps_the_cell_by_its_mix_kind(tmp_path):
    """`toy.root` (through `bench_port/conftest.py`) takes the cell like
    the train cells before it: every metric that lists it lists
    `toy.train`, and no metric names a cell the toy root lacks."""
    bench = common.benchmark(toy.root(str(tmp_path)))
    real = common.benchmark(toy.REPO)
    cells = {w["name"] for w in bench["workloads"]}
    assert cells == {"toy.train", "toy.serve"}
    for mine, base in zip(bench["end_to_end"] + bench["per_layer"],
                          real["end_to_end"] + real["per_layer"]):
        assert mine["name"] == base["name"]
        if CELL in base.get("workloads", []):
            assert "toy.train" in mine["workloads"], mine["name"]
        assert set(mine.get("workloads", [])) <= cells, mine["name"]


# seeds of default_nz18's readings (PERF.md)
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
def test_readings_hold_to_the_cells_limits(card):
    """calibrate.py's readings of the cell at its published widths on
    three seeds, printed with the card: the program against the
    reference over steps 0-2 passes the cell's limits, and every bf16
    control and half-batch fault fails one of them."""
    proc = subprocess.run(
        [toy.python(), "bench_port/calibrate.py", "--workload", CELL,
         "--seeds", ",".join(map(str, SEEDS)), "--controls", str(len(SEEDS))],
        cwd=toy.REPO, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    readings = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    print(f"card: {common.power_limit()}")
    for r in readings:
        print(f"{CELL} {json.dumps(r)}")
    assert len(readings) == 3 * len(SEEDS)
    limits = common.traffic_file(MIX)["limits"]
    for r in readings:
        failed = any(r[k] > limits[k] for k in limits)
        assert failed == (r["reading"] != "program"), r


if __name__ == "__main__":
    sys.path.insert(0, toy.REPO)
    with open(SNAPSHOT, "w") as f:
        json.dump(snapshot(load_raw(os.path.join(toy.REPO, "assets"))), f, indent=1)
        f.write("\n")
