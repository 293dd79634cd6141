"""The check fails what it must: the control (the reference in bfloat16
put in the program's place) and each fault a cell can have, planted in
the timed path underneath a whole run that skips only the look for a
card. Toy sizes on the CPU; the readings at the cells' own sizes come
from `calibrate.py` on the card (PERF.md)."""

import json
import subprocess

import numpy as np
import pytest
import torch

import cape_tpu_torch.train.loop as loop
from bench_port import common, program, serve_cell, train_cell
from bench_port.tests import toy

torch.set_num_threads(2)


def _train_cell():
    cf = toy.with_settings(toy.config())
    return cf, toy.TRAIN_MIX


def _bench():
    return {"end_to_end": [{"name": "setup_s", "unit": "s"},
                           {"name": "train_samples_per_s", "unit": "samples/s"}],
            "per_layer": []}


def _run_train(cf, mix):
    return train_cell.run(toy.args(seconds=0.2), 0.0, _bench(), {"name": "toy.train"}, cf, mix,
                          device="cpu")


def test_a_sound_run_is_correct():
    result, checks = _run_train(*_train_cell())
    assert result["correct"], checks


def test_control_bf16_fails():
    cf, mix = _train_cell()
    cfg = train_cell.program_config(cf, mix, toy.SEED, "toy")
    _, raw_of = train_cell.meshes(cf, cfg)
    raw = raw_of()
    want = train_cell.reference_steps(cf, mix, toy.SEED, "cpu", raw)
    ctrl = train_cell.reference_steps(cf, mix, toy.SEED, "cpu", raw, dtype=torch.bfloat16)
    gaps = train_cell.gaps(ctrl, want)
    assert any(v > mix["limits"][k] for k, v in gaps.items()), gaps


def test_state_left_unchanged_fails(monkeypatch):
    """A step that computes its losses and returns the state unchanged."""
    from cape_tpu_torch.train.step import gan_losses

    def frozen(state, ctx, batch, eps, reduce=None):
        _, metrics = gan_losses(state.model, state.model.cfg, ctx, batch, eps)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}, {}

    monkeypatch.setattr(loop, "train_step", frozen)
    result, checks = _run_train(*_train_cell())
    assert not result["correct"]
    assert checks["delta_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_fails(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    real = loop.train_step

    def half(state, ctx, batch, eps, reduce=None):
        k = len(eps) // 2
        return real(state, ctx, {n: v[:k] for n, v in batch.items()}, eps[:k], reduce)

    monkeypatch.setattr(loop, "train_step", half)
    result, checks = _run_train(*_train_cell())
    assert not result["correct"], checks


SERVE = """
import json, time
from bench_port import common, program, serve_cell
bench = common.benchmark({root!r})
wl = common.workload(bench, "toy.serve")
cf = common.config_file(bench, wl["config"], {root!r})
mix = common.traffic_file(wl["traffic"])
raw = program.toy_mesh(3, program.config(cf["settings"], batch_size=mix["batch_size"]))["raw"]
result, checks = serve_cell.run(__import__("types").SimpleNamespace(seed={seed}, seconds=2.0, trace=0),
                                time.perf_counter(), bench, wl, cf, mix, device="cpu",
                                bench_path={root!r} + "/BENCHMARK.json", raw=raw)
print(json.dumps({{"correct": result["correct"], "checks": checks}}))
"""

ALTER = '''
# planted by the benchmark's fault test: the engine's first generated
# mesh of every decode call moved where it is produced
import numpy as np
import cape_tpu_torch.apps.inference as inference

_decode = inference.InferenceEngine.decode


def decode(self, z_total, y, y2):
    out = _decode(self, z_total, y, y2)
    out[0] += 1e-3 * np.abs(out[0]).max()
    return out


inference.InferenceEngine.decode = decode
'''


def _serve(tmp_path, planted: bool):
    root = toy.root(str(tmp_path / "root"))
    env = toy.env(root)
    if planted:
        fault = tmp_path / "fault"
        fault.mkdir()
        (fault / "sitecustomize.py").write_text(ALTER)
        env["PYTHONPATH"] = f"{fault}:{env['PYTHONPATH']}"
    proc = subprocess.run([toy.python(), "-c", SERVE.format(root=root, seed=toy.SEED)],
                          cwd=root, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_serve_sound_and_altered_answer(tmp_path):
    sound = _serve(tmp_path / "a", planted=False)
    assert sound["correct"], sound
    altered = _serve(tmp_path / "b", planted=True)
    assert not altered["correct"]
    assert altered["checks"]["mesh_gap"]["value"] > toy.SERVE_MIX["limits"]["mesh_gap"]


def test_serve_control_bf16_fails():
    cf = toy.with_settings(toy.config())
    mix = {**toy.SERVE_MIX, "rate": 20.0}
    s = cf["settings"]
    raw = program.toy_mesh(3, program.config(s, batch_size=4))["raw"]
    gen = common.generator("serve")
    reqs = gen.requests(mix, toy.SEED, 2.0, stream=1)
    keep = gen.judged(mix, toy.SEED, reqs)
    from bench_port import weights
    from bench_port.reference import model as ref
    from bench_port.reference.mesh import RefMesh

    mesh = RefMesh(raw, "cpu")
    P = weights.make(ref.param_spec(s, mesh.level_sizes, mesh.level_sizes_d), toy.SEED, "cpu")
    served = {}
    for i in keep:
        r = reqs[i]
        served[i] = ref.sample_mesh(
            s, P, mesh, torch.as_tensor(gen.latents(r, s["nz"])),
            torch.as_tensor(r["pose"]).expand(r["n"], -1), torch.as_tensor(r["clo"]).expand(r["n"], -1),
            torch.bfloat16).float().numpy()
    gap = serve_cell.reference_gap(cf, mix, toy.SEED, reqs, served, "cpu", raw)
    assert gap > toy.SERVE_MIX["limits"]["mesh_gap"], gap
    assert np.isfinite(gap)
