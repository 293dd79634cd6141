"""The port's random draws against the JAX package's, on the CPU: the
initial parameters of init_params(PRNGKey(s)) for every family and preset,
Trainer.fit from a seed against JAX's Trainer.fit from that seed (float32
and bfloat16, across a chunk boundary mid-epoch, and resumed from JAX's
checkpoint), the fresh-init server's /decode against JAX's engine on
PRNGKey(cfg.seed) parameters, and bfloat16 evaluate, predict and sampled
autoencode against JAX's.

Nothing is passed in explicitly: each package draws its own parameters and
noise from the seed, so these tests fail wherever a draw of the port is not
JAX's. The model is the flagship family on the icosphere `small_mesh`
(4 layers, nf=8, batch 4), except where a preset or the full template is
named."""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cape_tpu.core.config import CAPEConfig as JaxConfig
from cape_tpu.models.cape import CAPE as JaxCAPE
from cape_tpu_torch.core import prng
from cape_tpu_torch.core.bridge import to_jax_params
from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.models.cape import CAPE

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_torch_golden import (  # noqa: E402
    METRICS, bf16_bounds, bf16_ulp_rel, summary_spread, update_summary,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
FLAGSHIP = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
B = 4
# 16 train rows at batch 4: 4 steps an epoch, in dispatch chunks of 2, so a
# chunk ends mid-epoch; every step's metrics are logged
TINY = dict(
    name="torch_random", num_conv_layers=4, nf=8, nz=8, nz_cond=8, nz_cond2=4,
    use_res_block=False, use_res_block_dec=True, affine=True, reduce_dim=4,
    batch_size=B, num_epochs=2, steps_per_dispatch=2, log_every_steps=1, tensorboard=False,
    data_parallel=1,
)
# the flagship family at test widths, and the plain decoder no preset uses
FAMILY_WIDTHS = dict(nf=8, nz=8, nz_cond=8, nz_cond2=4, reduce_dim=8)
FAMILIES = {
    **{os.path.basename(p)[:-5]: (p, {}) for p in PRESETS},
    "plain_decoder": (None, dict(use_res_block=False, use_res_block_dec=False, affine=False)),
    "no_reduce_two_layer_cond": (FLAGSHIP, dict(reduce_dim=0, n_layer_cond=2)),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _icosphere_contexts(small_mesh, ds_factors, dtype="float32", padded=True):
    """(JAX context, port context) of the icosphere pyramids."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, ds_factors)
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    edges = vertices_per_edge(faces, len(verts))
    return (jax_context(pyr, pyr_d, edges, verts, padded=padded, dtype=np.dtype(
                jax.numpy.bfloat16 if dtype == "bfloat16" else dtype)),
            build_graph_context(pyr, pyr_d, edges, verts, padded=padded,
                                dtype=getattr(torch, dtype)))


# ------------------------------------------------------------ parameters
@pytest.mark.parametrize("seed", [0, 123])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_params_is_jax_init_params(small_mesh, family, seed):
    """CAPE.init_params(prng.PRNGKey(s)) against JAX's init_params(
    PRNGKey(s)) through the bridge, for every preset (its structure at test
    widths) and the plain decoder: the same leaves, shapes and dtypes, each
    within 2.4e-7 absolute (one float32 ulp of the truncated normal's 2,
    before the 0.1 scale; glorot leaves and constants bit-equal)."""
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu_torch.core.config import load_config

    preset, change = FAMILIES[family]
    over = dict(FAMILY_WIDTHS, **change)
    if preset is not None and load_config(preset).reduce_dim == 0:
        over["reduce_dim"] = 0
    cfg = load_config(preset, **over) if preset else CAPEConfig(**over)
    jcfg = jax_load_config(preset, **over) if preset else JaxConfig(**over)
    jctx, ctx = _icosphere_contexts(small_mesh, cfg.ds_factors, padded=False)
    got = _flat(to_jax_params(CAPE(cfg).init_params(prng.PRNGKey(seed), ctx)))
    want = _flat(JaxCAPE(jcfg).init_params(jax.random.PRNGKey(seed), jctx))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2.4e-7, err_msg=k)
        if k.endswith("kernel") or not k.endswith("w"):
            np.testing.assert_array_equal(got[k], w, err_msg=k)


# ------------------------------------------------------------------ fits
@pytest.fixture(scope="module")
def setup(small_mesh):
    """Contexts of both packages in f32 and bf16 (padded layout) and the
    synthetic data: 16 train rows, 8 val rows (the last 8 of 24), 6 test rows."""
    from cape_tpu_torch.data.synthetic import synthetic_bodydata

    ctxs = {d: _icosphere_contexts(small_mesh, CAPEConfig(**TINY).ds_factors, d)
            for d in ("float32", "bfloat16")}
    data = synthetic_bodydata(n_train=24, n_test=6, num_verts=len(small_mesh[0]), seed=0,
                              n_val=8)
    return ctxs, data


def _records(run_dir):
    """(per-step metrics {step: [METRICS]}, the epoch records) of a run's
    metrics.jsonl."""
    steps, epochs = {}, []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for rec in map(json.loads, f):
            if "epoch" in rec:
                epochs.append(rec)
            else:
                steps[rec["step"]] = [rec[k] for k in METRICS]
    return steps, epochs


class Bf16EpsCAPE(JaxCAPE):
    """JAX's model whose sample_z draws eps in bfloat16 and widens it: an
    f32 run on a bf16 run's noise, which isolates bf16 compute's effect."""

    def sample_z(self, rng, z_mean, z_logvar):
        eps = jax.random.normal(rng, z_mean.shape, jax.numpy.bfloat16).astype(z_mean.dtype)
        return z_mean + jax.numpy.exp(0.5 * jax.numpy.clip(z_logvar, -30.0, 30.0)) * eps


def _jax_fit(setup, workdir, dtype="float32", model_cls=JaxCAPE, **change):
    """JAX's Trainer.fit from cfg.seed: (val recons, per-step metrics,
    epoch records, initial and final parameters by dotted path)."""
    from cape_tpu.train.loop import Trainer as JaxTrainer

    ctxs, data = setup
    jcfg = JaxConfig(**{**TINY, **change}, compute_dtype=dtype)
    trainer = JaxTrainer(jcfg, model_cls(jcfg), ctxs[dtype][0], data, workdir=str(workdir))
    val, _ = trainer.fit()
    init = _flat(JaxCAPE(jcfg).init_params(jax.random.PRNGKey(jcfg.seed), ctxs[dtype][0]))
    steps, epochs = _records(trainer.run_dir)
    return dict(val=np.array(val), steps=steps, epochs=epochs, init=init,
                final=_flat(jax.device_get(trainer.state.params)), run_dir=trainer.run_dir)


def _port_fit(setup, workdir, dtype="float32", **change):
    """The port's Trainer.fit, its model from init_params(PRNGKey(cfg.seed))
    as apps.main draws it; the same record as _jax_fit."""
    from cape_tpu_torch.train.loop import Trainer

    ctxs, data = setup
    cfg = CAPEConfig(**{**TINY, **change}, compute_dtype=dtype)
    model = CAPE(cfg).init_params(prng.PRNGKey(cfg.seed), ctxs[dtype][1])
    trainer = Trainer(cfg, model, ctxs[dtype][1], data, workdir=str(workdir))
    val, _ = trainer.fit()
    steps, epochs = _records(trainer.run_dir)
    return dict(val=np.array(val), steps=steps, epochs=epochs,
                final=_flat(to_jax_params(trainer.model)), trainer=trainer)


@pytest.fixture(scope="module")
def jax_f32(setup, tmp_path_factory):
    """JAX's f32 fit: 2 epochs of 4 steps from seed 123."""
    return _jax_fit(setup, tmp_path_factory.mktemp("jax_f32"))


def _hold_fit(got, want, steps):
    """Each logged metric of `steps` within 1e-4 relative, each epoch's val
    recon within 1e-4 * max|val|, each final leaf within 1e-3 of its
    max|final - init| in JAX's run plus one float32 ulp of its max|leaf| per
    step (each step rounds p + u to float32, and two implementations' u
    part by float noise, so a leaf that barely moves can end an ulp apart
    per step)."""
    assert sorted(got["steps"]) == sorted(want["steps"]) == list(steps)
    for s in steps:
        np.testing.assert_allclose(got["steps"][s], want["steps"][s], rtol=1e-4, atol=1e-7,
                                   err_msg=f"step {s}")
    np.testing.assert_allclose(got["val"], want["val"], rtol=0,
                               atol=1e-4 * np.abs(want["val"]).max())
    assert sorted(got["final"]) == sorted(want["final"])
    for k, w in want["final"].items():
        scale = np.abs(w - want["init"][k]).max()
        assert scale > 0, k
        ulps = len(steps) * np.spacing(np.abs(w).max())
        np.testing.assert_allclose(got["final"][k], w, rtol=0, atol=1e-3 * scale + ulps,
                                   err_msg=k)


def test_fit_from_a_seed_is_jax_fit(setup, jax_f32, tmp_path):
    """The port's Trainer.fit from seed 123 (parameters from PRNGKey(123),
    step s's eps normal(fold_in(PRNGKey(123), s)), eval eps JAX's) against
    JAX's Trainer.fit from seed 123, f32, 2 epochs in dispatch chunks of 2
    (a chunk boundary mid-epoch): every step's metrics, both val recons and
    the final parameters, by _hold_fit's tolerances; the epoch records sit
    at the same steps."""
    got = _port_fit(setup, tmp_path)
    _hold_fit(got, jax_f32, range(8))
    assert [r["step"] for r in got["epochs"]] == [r["step"] for r in jax_f32["epochs"]] == [3, 7]
    assert got["trainer"].state.step == 8


def test_resume_from_jax_checkpoint_continues_jax_run(setup, jax_f32, tmp_path):
    """A port run resumed (restart=False) from the JAX run's checkpoint at
    step 4 trains 1 epoch more: its steps 4-7, its val recon and its final
    parameters are those of JAX's uninterrupted 2-epoch run, by _hold_fit's
    tolerances."""
    src = os.path.join(jax_f32["run_dir"], "checkpoints", "ckpt_0000000004.npz")
    dst = tmp_path / TINY["name"] / "checkpoints"
    dst.mkdir(parents=True)
    shutil.copy(src, dst)
    got = _port_fit(setup, tmp_path, restart=False, num_epochs=1)
    assert got["trainer"].state.step == 8
    want = dict(jax_f32, steps={s: jax_f32["steps"][s] for s in range(4, 8)},
                val=jax_f32["val"][1:])
    _hold_fit(got, want, range(4, 8))


def test_bf16_fit_from_a_seed_within_the_derived_bound(setup, tmp_path):
    """The port's bf16 fit from seed 123 against JAX's bf16 fit from seed
    123 (eps drawn in bfloat16 by both), held by make_torch_golden's
    bf16_bounds: twice bf16 compute's effect in JAX itself (its bf16 fit
    against its f32 fit on the same bf16-drawn eps), per metric (the
    largest over the steps), per epoch's val recon, and per player's leaves
    of the whole update final - init."""
    want = _jax_fit(setup, tmp_path / "jax_bf16", "bfloat16")
    f32 = _jax_fit(setup, tmp_path / "jax_f32", "float32", model_cls=Bf16EpsCAPE)
    got = _port_fit(setup, tmp_path / "port", "bfloat16")
    steps = range(8)
    assert sorted(got["steps"]) == sorted(want["steps"]) == list(steps)
    keys = sorted(want["final"])
    upd = lambda run: {k: run["final"][k] - want["init"][k] for k in keys}
    summ = lambda u: np.stack([update_summary(u[k]) for k in keys])
    mat = lambda run: np.array([run["steps"][s] for s in steps])
    metric_bound, update_bound = bf16_bounds(
        mat(want), mat(f32), summ(upd(want)), summ(upd(f32)), keys,
        [want["final"][k].size for k in keys])
    # a step's effect is one draw of rounding noise, so a metric's steps
    # share its largest (bf16's kl sums terms near 1 and is a multiple of
    # 2^-10 near 0.002: JAX's own bf16 kl moves by that quantum step to step)
    metric_bound = metric_bound.max(axis=0)
    err = np.abs(mat(got) - mat(want)) / np.abs(mat(want))
    bad = [(s, METRICS[j], err[s, j], metric_bound[j]) for s, j in zip(*np.nonzero(
        err > metric_bound))]
    assert not bad, bad
    val_bound = np.maximum(2 * np.abs(want["val"] - f32["val"]) / f32["val"],
                           bf16_ulp_rel(want["val"]))
    assert (np.abs(got["val"] - want["val"]) / want["val"] <= val_bound).all(), \
        (got["val"], want["val"], val_bound)
    spread = summary_spread(summ(upd(want)), summ(upd(got)),
                            np.array([want["final"][k].size for k in keys]))
    for k, e, b in zip(keys, spread, update_bound):
        assert e <= b, f"{k}: {e} > {b}"


# -------------------------------------------------------- bf16 inference
def test_bf16_evaluate_predict_and_sampled_autoencode_match_jax(setup, tmp_path, monkeypatch):
    """In compute_dtype=bfloat16 the eval, predict and sampled-autoencode
    noise is JAX's bfloat16 draw, bit for bit: each eval batch's eps is
    jax.random.normal(fold_in(fold_in(PRNGKey(seed), 7), begin), (B, nz),
    bfloat16) in Trainer.evaluate(key=7), fold_in(PRNGKey(3), begin) in
    Trainer.predict, and the engine's sampled rows are JAX's
    _sample_z_rows draw under seed 5 (z within 2^-7 * max|z| of JAX's z on
    the same z_mean and z_logvar). From the same PRNGKey(123) parameters,
    the eval metrics, the predictions and the sampled meshes equal JAX's
    Trainer and engine within 2^-7 relative (metrics) and 2^-7 * max|ref|
    (meshes), the bf16 eval step's tolerances."""
    import jax.numpy as jnp

    from cape_tpu.apps.inference import InferenceEngine as JaxEngine
    from cape_tpu.apps.inference import _sample_z_rows
    from cape_tpu.train.loop import Trainer as JaxTrainer
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.train import loop

    ctxs, data = setup
    jctx, ctx = ctxs["bfloat16"]
    cfg = CAPEConfig(**TINY, compute_dtype="bfloat16")
    jcfg = JaxConfig(**TINY, compute_dtype="bfloat16")
    model = CAPE(cfg).init_params(prng.PRNGKey(cfg.seed), ctx)
    params = jax.tree_util.tree_map(np.asarray, to_jax_params(model))
    trainer = loop.Trainer(cfg, model, ctx, data, workdir=str(tmp_path / "port"))
    jtrainer = JaxTrainer(jcfg, JaxCAPE(jcfg), jctx, data, workdir=str(tmp_path / "jax"))
    seen, eval_step = [], loop.eval_step

    def recorded(model, cfg, ctx, batch, eps):
        seen.append(eps.clone())
        return eval_step(model, cfg, ctx, batch, eps)

    monkeypatch.setattr(loop, "eval_step", recorded)

    def jax_eps(key, n_rows):
        return [np.asarray(jax.random.normal(jax.random.fold_in(key, b), (B, cfg.nz),
                                             jnp.bfloat16)).astype(np.float32)
                for b in range(0, n_rows, B)]

    def held_eps(want):
        assert len(seen) == len(want)
        for got, w in zip(seen, want):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), w)
        seen.clear()

    class State:
        pass

    state = State()
    state.params = params
    val = trainer.evaluate("val", key=7)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 7)
    held_eps(jax_eps(key, len(data.disp_val)))
    jval = jtrainer.evaluate("val", state=state, rng=key)
    assert val.keys() == jval.keys()
    for k in val:
        np.testing.assert_allclose(val[k], jval[k], rtol=2**-7, err_msg=k)
    disp, pose, clo = data.split("test")
    got = trainer.predict(disp, pose, clo, rng=prng.PRNGKey(3))
    held_eps(jax_eps(jax.random.PRNGKey(3), len(disp)))
    want = jtrainer.predict(disp, pose, clo, state=state, rng=jax.random.PRNGKey(3))
    np.testing.assert_allclose(got, want, rtol=0, atol=2**-7 * np.abs(want).max())

    sampled, sample_z = [], CAPE.sample_z

    def recorded_z(z_mean, z_logvar, eps):
        z = sample_z(z_mean, z_logvar, eps)
        sampled.append((z_mean, z_logvar, eps, z))
        return z

    monkeypatch.setattr(CAPE, "sample_z", staticmethod(recorded_z))
    eng = InferenceEngine(model, ctx, batch_size=B, device="cpu")
    jeng = JaxEngine(JaxCAPE(jcfg), jctx, params, batch_size=B)
    got = eng.autoencode(disp, pose, clo, rng=5, sample=True)
    assert eng.calls["sample"] == len(sampled) == 2   # 6 rows at batch 4
    zm, zl, eps, z = (torch.cat([s[i] for s in sampled])[: len(disp)] for i in range(4))
    assert {t.dtype for t in (zm, zl, eps, z)} == {torch.bfloat16}
    as_jnp = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    offsets = np.arange(len(disp), dtype=np.int32)
    np.testing.assert_array_equal(
        eps.float().numpy(),
        np.asarray(_sample_z_rows(np.uint32(5), offsets, jnp.zeros_like(as_jnp(zm)),
                                  jnp.zeros_like(as_jnp(zl)))).astype(np.float32))
    jz = np.asarray(_sample_z_rows(np.uint32(5), offsets, as_jnp(zm), as_jnp(zl)), np.float32)
    np.testing.assert_allclose(z.float().numpy(), jz, rtol=0, atol=2**-7 * np.abs(jz).max())
    want = np.asarray(jeng.autoencode(disp, pose, clo, rng=5, sample=True), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2**-7 * np.abs(want).max())


# ---------------------------------------------------------------- server
def test_fresh_init_server_decodes_as_jax_engine(flagship_ctx):
    """`python -m cape_tpu_torch.apps.server --fresh-init` on the CPU (the
    flagship template at nf=8) draws init_params(PRNGKey(cfg.seed)), as
    JAX's server does: its /decode of 4 latent rows equals JAX's engine on
    JAX's PRNGKey(cfg.seed) parameters within 1e-4 * max|ref|."""
    from cape_tpu.apps.inference import InferenceEngine as JaxEngine
    from cape_tpu.core.config import parse_cli

    flags = ["--config", FLAGSHIP, "--name", "fresh", "--batch_size", "4", "--nf", "8",
             "--nz", "18", "--nz_cond", "24", "--nz_cond2", "8", "--reduce_dim", "8"]
    jcfg = parse_cli(flags)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((4, jcfg.nz)).astype(np.float32)
    pose = (0.5 * rng.standard_normal((1, jcfg.cond_dim))).astype(np.float32)
    clo = np.eye(jcfg.cond2_dim, dtype=np.float32)[[1]]

    cmd = [sys.executable, "-m", "cape_tpu_torch.apps.server", *flags, "--fresh-init",
           "--device", "cpu", "--port", "0"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    watchdog = threading.Timer(180, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        assert lines and lines[-1].startswith("serving fresh on http://"), lines
        base = lines[-1].split(" on ")[1].strip()
        body = json.dumps({"z": z.tolist(), "pose": pose.tolist(), "clo": clo.tolist()})
        req = urllib.request.Request(base + "/decode", data=body.encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = np.asarray(json.loads(resp.read())["disp"], np.float32)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

    model = JaxCAPE(jcfg)
    jeng = JaxEngine(model, flagship_ctx,
                     model.init_params(jax.random.PRNGKey(jcfg.seed), flagship_ctx),
                     batch_size=4)
    y, y2 = jeng.encode_only_condition(pose, clo)
    y, y2 = np.repeat(y, 4, axis=0), np.repeat(y2, 4, axis=0)
    want = jeng.decode(np.concatenate([z, y, y2], axis=-1), y, y2)
    assert got.shape == want.shape == (4, 6890, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_flagship_init_holds_to_the_init_golden():
    """chip_smoke.hold_init, phase 23 (a)'s check, on the CPU: the flagship
    preset's init_params(prng.PRNGKey(cfg.seed)) at full width against
    JAX's fingerprint in tests/data/torch_golden_init.npz (written by
    `make_torch_golden.py init`), every measure within its bound (INIT_ULP
    per entry); the test form's parameters (torch.Generator seed 123) are
    refused."""
    import chip_smoke
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config

    cfg = load_config(FLAGSHIP)
    golden = np.load(os.path.join(ROOT, "tests", "data", "torch_golden_init.npz"))
    assert int(golden["seed"]) == cfg.seed
    ctx = build_context(cfg, device="cpu")
    model = CAPE(cfg).init_params(prng.PRNGKey(cfg.seed), ctx)
    assert chip_smoke.hold_init(model.state_dict(), golden) <= 1.0
    other = CAPE(cfg).init_params(torch.Generator().manual_seed(cfg.seed), ctx)
    with pytest.raises(AssertionError, match="init "):
        chip_smoke.hold_init(other.state_dict(), golden)
