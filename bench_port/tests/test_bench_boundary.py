"""The import boundary: no run path loads a module whose top-level name is
`jax`, `jaxlib`, `flax` or `cape_tpu` (compared whole: `cape_tpu_torch`
is the program and allowed), and the reference loads nothing of the
program. Each path runs in a subprocess of its own, at toy size on the
CPU."""

import json
import subprocess

from bench_port.tests import toy

FORBIDDEN = {"jax", "jaxlib", "flax", "cape_tpu"}

CELL = """
import json, sys, time, types, importlib
T0 = time.perf_counter()
from bench_port import common, program
bench = common.benchmark({root!r})
wl = common.workload(bench, {wl!r})
cf = common.config_file(bench, wl["config"], {root!r})
mix = common.traffic_file(wl["traffic"])
cell = importlib.import_module("bench_port." + mix["kind"] + "_cell")
kw = {{"device": "cpu"}}
if mix["kind"] == "serve":
    cfg = program.config(cf["settings"], batch_size=mix["batch_size"])
    kw.update(bench_path={root!r} + "/BENCHMARK.json", raw=program.toy_mesh(3, cfg)["raw"])
args = types.SimpleNamespace(seed={seed}, seconds=1.0, trace={trace})
result, checks = cell.run(args, T0, bench, wl, cf, mix, **kw)
print(json.dumps({{"tops": sorted({{n.split(".")[0] for n in sys.modules}}),
                  "child": result.get("forbidden", []), "correct": result["correct"]}}))
"""

REFERENCE = """
import json, sys, torch
from bench_port.reference import mesh, model, prng
raw = mesh.load_raw({repo!r} + "/assets")
m = mesh.RefMesh(raw, "cpu")
s = json.load(open({repo!r} + "/bench_port/configs/affine_nz64.json"))
s = {{**s["defaults"], **s["preset"], "nf": 8, "reduce_dim": 8}}
spec = model.param_spec(s, m.level_sizes, m.level_sizes_d)
P = {{k: torch.full(shape, 0.01) if init in ("trunc", "glorot") else torch.full(shape, float(init))
     for k, (shape, init) in spec.items()}}
x = model.sample_mesh(s, P, m, torch.zeros(2, s["nz"]), torch.zeros(2, 126), torch.zeros(2, 4),
                      torch.float32)
eps = prng.step_noise(7, range(2), 2, s["nz"])
print(json.dumps({{"tops": sorted({{n.split(".")[0] for n in sys.modules}}),
                  "shape": list(x.shape)}}))
"""


def _python(code, root):
    proc = subprocess.run([toy.python(), "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=900, env=toy.env(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_run_paths_load_no_jax(tmp_path):
    root = toy.root(str(tmp_path))
    for wl in ("toy.train", "toy.serve"):
        for trace in (0, 1):
            out = _python(CELL.format(root=root, wl=wl, seed=toy.SEED, trace=trace), root)
            assert out["correct"], (wl, trace)
            assert "cape_tpu_torch" in out["tops"]
            assert not FORBIDDEN & set(out["tops"]), (wl, trace, FORBIDDEN & set(out["tops"]))
            assert not out["child"], out["child"]


def test_the_reference_loads_nothing_of_the_program():
    out = _python(REFERENCE.format(repo=toy.REPO), toy.REPO)
    assert out["shape"] == [2, 6890, 3]
    assert not ({"cape_tpu_torch"} | FORBIDDEN) & set(out["tops"])
