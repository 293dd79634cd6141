"""A configuration, a traffic mix and a per-layer metric added as files
and entries alone, in a temporary copy of the benchmark, are found by
name and reported."""

import json
import os

from bench_port.tests import toy

READER = '''"""steps_seen.train: the profiled stretch's steps (a test metric)."""


def read(m):
    return m.get("profiled_steps")
'''

CHECK = """
import json, sys, time, types
from bench_port import common, train_cell
bench = common.benchmark({root!r})
wl = common.workload(bench, "new.train")
cf = common.config_file(bench, wl["config"], {root!r})
mix = common.traffic_file(wl["traffic"])
e2e, per = common.cell_metrics(bench, "new.train")
result, checks = train_cell.run(types.SimpleNamespace(seed=5, seconds=0.5, trace=1),
                                time.perf_counter(), bench, wl, cf, mix, device="cpu")
print(json.dumps({{"nz": cf["settings"]["nz"], "batch": mix["batch_size"],
                  "per": [m["name"] for m in per], "metrics": result["metrics"],
                  "correct": result["correct"]}}))
"""


def test_new_files_are_found_by_name(tmp_path):
    import subprocess

    root = toy.root(str(tmp_path))
    bp = os.path.join(root, "bench_port")
    cf = toy.config()
    cf["preset"]["nz"] = 6
    with open(os.path.join(bp, "configs", "new.json"), "w") as f:
        json.dump(cf, f)
    with open(os.path.join(bp, "traffic", "train.new.json"), "w") as f:
        json.dump({**toy.TRAIN_MIX, "batch_size": 2}, f)
    with open(os.path.join(bp, "metrics", "steps_seen.train.py"), "w") as f:
        f.write(READER)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "new", "source": "test", "file": "bench_port/configs/new.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new.train", "config": "new", "traffic": "train.new",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][1]["workloads"].append("new.train")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "Test",
                               "moves": "train_samples_per_s", "workloads": ["new.train"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    proc = subprocess.run([toy.python(), "-c", CHECK.format(root=root)], cwd=root,
                          capture_output=True, text=True, timeout=600, env=toy.env(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (out["nz"], out["batch"]) == (6, 2)
    assert out["per"] == ["steps_seen.train"]
    assert out["metrics"] == {"steps_seen.train": {"value": 1, "unit": "steps"}}
    assert out["correct"]


DEFAULT = """
import json, time, types, torch
from bench_port import common, flops, train_cell
bench = common.benchmark({root!r})
wl = common.workload(bench, "default.train")
cf = common.config_file(bench, wl["config"], {root!r})
mix = common.traffic_file(wl["traffic"])
counted = []
real = flops.Counter.train_step
flops.Counter.train_step = lambda self, B: counted.append(real(self, B)) or counted[-1]
result, checks = train_cell.run(types.SimpleNamespace(seed={seed}, seconds=0.5, trace=1),
                                time.perf_counter(), bench, wl, cf, mix, device="cpu")
_, raw_of = train_cell.meshes(cf, train_cell.program_config(cf, mix, {seed}, "default.train"))
raw = raw_of()
want = train_cell.reference_steps(cf, mix, {seed}, "cpu", raw)
control = train_cell.gaps(
    train_cell.reference_steps(cf, mix, {seed}, "cpu", raw, dtype=torch.bfloat16), want)
s = cf["settings"]
plain = real(flops.Counter({{**s, "use_res_block": 0, "cond_encoder": 0}}, raw),
            mix["batch_size"])
print(json.dumps({{"correct": result["correct"], "checks": checks, "metrics": result["metrics"],
                  "family": [s["use_res_block"], s["cond_encoder"], s["reduce_dim"]],
                  "counted": counted, "plain": plain, "control": control,
                  "limits": mix["limits"]}}))
"""


def _tree(path: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(path):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", "tests")]
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), path)] = f.read()
    return out


def test_default_config_by_files_alone(tmp_path):
    """configs/default_config.yaml's family (residual encoder, conditions
    on it, a 4-channel bottleneck) at toy widths, added as a configuration
    file, a train mix and entries in the copy's BENCHMARK.json: its whole
    train cell runs correct, its bf16 control fails the check, and
    step_mfu.train reads the widened count, with no file of the benchmark
    edited."""
    import subprocess

    root = toy.root(str(tmp_path))
    bp = os.path.join(root, "bench_port")
    with open(os.path.join(bp, "configs", "default_toy.json"), "w") as f:
        json.dump(toy.default_config(), f)
    with open(os.path.join(bp, "traffic", "train.default_toy.json"), "w") as f:
        json.dump(toy.TRAIN_MIX, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "default_toy", "source": "test",
                             "file": "bench_port/configs/default_toy.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "default.train", "config": "default_toy",
                               "traffic": "train.default_toy", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "toy.train" in m.get("workloads", []):
            m["workloads"].append("default.train")
    with open(path, "w") as f:
        json.dump(bench, f)
    proc = subprocess.run([toy.python(), "-c", DEFAULT.format(root=root, seed=toy.SEED)],
                          cwd=root, capture_output=True, text=True, timeout=600, env=toy.env(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["family"] == [1, 1, 4]
    assert out["correct"], out["checks"]
    assert any(v > out["limits"][k] for k, v in out["control"].items()), out["control"]
    assert len(out["counted"]) == 1 and out["counted"][0] > out["plain"]
    assert out["metrics"]["step_mfu.train"]["value"] > 0
    copied = _tree(bp)
    assert all(copied[name] == data for name, data in _tree(toy.BENCH_DIR).items())
