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
