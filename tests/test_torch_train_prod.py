"""The JAX package's production training setup in the PyTorch port, against
the JAX package on the CPU: bf16 compute (f32 parameters and gradients),
bf16 optimizer state, whole-train-state checkpoints that either package
resumes, resume bit-equal to an uninterrupted run, TensorBoard events,
profile_steps and the dashboard. The icosphere model is the flagship family
cut to 4 layers, nf=8, batch 4, as in tests/test_torch_train.py;
parameters come from the port's seed-0 init through the bridge, inputs and
the reparameterization noise from numpy."""

import glob
import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cape_tpu.core.config import CAPEConfig as JaxConfig
from cape_tpu.models.cape import CAPE as JaxCAPE
from cape_tpu_torch.core.bridge import to_jax_params
from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.models.cape import CAPE

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_torch_golden import METRICS, bf16_bounds, update_summary  # noqa: E402

torch.set_num_threads(1)

B = 4
TINY = dict(
    name="torch_train_prod", num_conv_layers=4, nf=8, nz=8, nz_cond=8, nz_cond2=4,
    use_res_block=False, use_res_block_dec=True, affine=True, reduce_dim=4,
    batch_size=B, num_epochs=1,
)


class EpsCAPE(JaxCAPE):
    """The JAX model with the reparameterization noise given by the caller
    (the `rng` argument), in z_mean's dtype as JAX's own sample_z draws it."""

    def sample_z(self, rng, z_mean, z_logvar):
        return z_mean + jnp.exp(0.5 * jnp.clip(z_logvar, -30.0, 30.0)) * rng.astype(z_mean.dtype)


@pytest.fixture(scope="module")
def setup(small_mesh):
    """Both packages' contexts of the icosphere pyramids (padded layout), f32
    and bf16, and the synthetic data."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, CAPEConfig(**TINY).ds_factors)
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    edges = vertices_per_edge(faces, len(verts))
    ctxs = {}
    for name, np_dtype, dtype in (("float32", np.float32, torch.float32),
                                  ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        ctxs[name] = (jax_context(pyr, pyr_d, edges, verts, padded=True, dtype=np_dtype),
                      build_graph_context(pyr, pyr_d, edges, verts, padded=True, dtype=dtype))
    data = synthetic_bodydata(n_train=32, n_test=6, num_verts=len(verts), seed=0, n_val=8)
    return ctxs, data


@pytest.fixture
def kernel_route(monkeypatch):
    """The large-batch route lowered to batch 4 in both packages: JAX runs
    Pallas v3 (interpret mode) in both directions, the port its band-apply
    plain version."""
    import cape_tpu.ops.cheb as jax_cheb
    from cape_tpu_torch.ops import cheb

    for mod in (jax_cheb, cheb):
        monkeypatch.setattr(mod, "VM_MIN_BATCH", B)
        monkeypatch.setattr(mod, "VM_MIN_COLS", B * 3)


def _model(cfg, ctx, seed=0):
    return CAPE(cfg).init_params(torch.Generator().manual_seed(seed), ctx)


def _jax_tree(model):
    return jax.tree_util.tree_map(jnp.asarray, to_jax_params(model))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _batches(data, perm, n_steps, seed=0):
    from cape_tpu_torch.data.loader import BatchStream

    n = len(data.disp_train)
    sg, sd = BatchStream(n, B, seed), BatchStream(n, B, seed + 1)
    disp = data.disp_train[:, perm]
    out = []
    for _ in range(n_steps):
        ig, idd = sg.next_indices(), sd.next_indices()
        out.append({
            "disp_g": disp[ig], "pose_g": data.pose_train[ig], "clo_g": data.clo_train[ig],
            "disp_d": disp[idd], "pose_d": data.pose_train[idd], "clo_d": data.clo_train[idd],
        })
    return out


def _jax_steps(params, jcfg, jctx, batches, eps, spe):
    """JAX's jitted train step (build_train_step's body, returning the
    updates) over the batches: (metrics per step, metric dtypes, last
    updates by dotted path)."""
    from cape_tpu.train.optim import TrainState, build_optimizer, create_train_state
    from cape_tpu.train.step import _gan_losses

    tx, _, _ = build_optimizer(jcfg, spe)
    state = create_train_state(params, tx)
    jmodel = EpsCAPE(jcfg)

    @jax.jit
    def step_fn(state, batch, eps):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: _gan_losses(jmodel, jcfg, p, jctx, batch, eps), has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype), state.params, updates)
        return TrainState(step=state.step + 1, params=new, opt_state=opt_state), metrics, updates

    out = []
    for batch, e in zip(batches, eps):
        state, m, updates = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jnp.asarray(e))
        out.append({k: float(m[k]) for k in METRICS})
    return out, {k: str(m[k].dtype) for k in METRICS}, _flat(jax.device_get(updates))


def _port_steps(model, cfg, ctx, batches, eps, spe):
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    state = TrainState(model, Optimizer(cfg, spe))
    out = []
    for batch, e in zip(batches, eps):
        m, updates = train_step(state, ctx, {k: torch.from_numpy(v) for k, v in batch.items()},
                                torch.from_numpy(e))
        out.append({k: float(m[k]) for k in METRICS})
    return out, {k: str(m[k].dtype).replace("torch.", "") for k in METRICS}, \
        {k: v.numpy() for k, v in updates.items()}, state


@pytest.mark.parametrize("opt_state_dtype", ["float32", "bfloat16"])
def test_bf16_train_step_within_the_derived_bound_of_jax(setup, kernel_route, opt_state_dtype):
    """Two GAN steps in compute_dtype=bfloat16 (warmup: step 2's update
    carries both gradients), kernel route, in the port and in JAX from the
    same parameters, batches and eps. Each metric has JAX's dtype (recon,
    kl, edge, the GAN terms and loss_d bf16; reg_g and loss_g f32), the
    parameters and updates stay f32, and the port is held to JAX's bf16
    step by bounds derived from bf16's effect in JAX itself (JAX's bf16
    step against its f32 step; make_torch_golden.bf16_bounds): each metric
    within its bound, each leaf's update summary within its player's
    bound (G or D: twice the largest such effect over that player's
    leaves)."""
    ctxs, data = setup
    kw = dict(TINY, lr_warmup=True)
    f32_model = _model(CAPEConfig(**kw), ctxs["float32"][1])
    params = _jax_tree(f32_model)
    spe = len(data.disp_train) // B
    batches = _batches(data, ctxs["float32"][1].perm0, 2)
    eps = np.random.default_rng(9).standard_normal((2, B, 8)).astype(np.float32)
    runs = {}
    for dtype, extra in (("float32", {}), ("bfloat16", {"opt_state_dtype": opt_state_dtype})):
        jcfg = JaxConfig(**kw, compute_dtype=dtype, **extra)
        runs[dtype] = _jax_steps(params, jcfg, ctxs[dtype][0], batches, eps, spe)
    cfg = CAPEConfig(**kw, compute_dtype="bfloat16", opt_state_dtype=opt_state_dtype)
    model = _model(cfg, ctxs["bfloat16"][1])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got, dtypes, updates, state = _port_steps(model, cfg, ctxs["bfloat16"][1], batches, eps, spe)
    want, want_dtypes, want_updates = runs["bfloat16"]
    assert dtypes == want_dtypes
    assert want_dtypes["recon"] == "bfloat16" and want_dtypes["loss_g"] == "float32"
    keys = sorted(want_updates)
    assert sorted(updates) == keys and all(u.dtype == np.float32 for u in updates.values())
    summ = lambda u: np.stack([update_summary(u[k]) for k in keys])
    metric_bound, update_bound = bf16_bounds(
        np.array([[m[k] for k in METRICS] for m in want]),
        np.array([[m[k] for k in METRICS] for m in runs["float32"][0]]),
        summ(want_updates), summ(runs["float32"][2]), keys,
        [want_updates[k].size for k in keys])
    for i in range(2):
        for j, k in enumerate(METRICS):
            err = abs(got[i][k] - want[i][k]) / abs(want[i][k])
            assert err <= metric_bound[i, j], f"step {i + 1} {k}: {err} > {metric_bound[i, j]}"
    for k, u, bound in zip(keys, summ(updates), update_bound):
        r_sum, r_sq, r_max = update_summary(want_updates[k])
        n = want_updates[k].size
        errs = [abs(u[2] - r_max) / r_max, abs(u[1] - r_sq) / (2 * r_sq),
                abs(u[0] - r_sum) / np.sqrt(n * r_sq)]
        assert max(errs) <= bound, f"{k}: {errs} > {bound}"
    stored = {b.dtype for bufs in state.tx.buffers.values() for b in bufs.values()}
    assert stored == {getattr(torch, opt_state_dtype)}


def test_bf16_eval_step_metrics_leave_as_f32(setup):
    """In bf16 compute, eval_step's prediction and per-sample metrics leave
    as f32, as JAX's eval step casts them, and agree with JAX's within one
    bf16 ulp of max|ref| (prediction) and 2^-7 relative (metrics)."""
    from cape_tpu.train.step import build_eval_step
    from cape_tpu_torch.train.step import eval_step

    ctxs, data = setup
    jctx, ctx = ctxs["bfloat16"]
    cfg = CAPEConfig(**TINY, compute_dtype="bfloat16")
    jcfg = JaxConfig(**TINY, compute_dtype="bfloat16")
    model = _model(cfg, ctx)
    disp, pose, clo = (a[:B] for a in data.split("val"))
    batch = {"disp": disp[:, ctx.perm0], "pose": pose, "clo": clo}
    eps = np.random.default_rng(8).standard_normal((B, cfg.nz)).astype(np.float32)
    jpred, jm = jax.jit(build_eval_step(EpsCAPE(jcfg), jcfg))(
        _jax_tree(model), jctx, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(eps))
    pred, m = eval_step(model, cfg, ctx, {k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.from_numpy(eps))
    assert pred.dtype == torch.float32 and jpred.dtype == jnp.float32
    jpred = np.asarray(jpred)
    np.testing.assert_allclose(pred.numpy(), jpred, rtol=0, atol=2**-7 * np.abs(jpred).max())
    for k in jm:
        assert m[k].dtype == torch.float32 and jm[k].dtype == jnp.float32
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=2**-7, err_msg=k)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_bf16_optimizer_state_matches_optax(setup, optimizer):
    """Three successive updates with opt_state_dtype=bfloat16 against the
    JAX package's build_optimizer (optax, op by op) on the same gradients,
    per leaf, within 1e-5 relative of the leaf's largest update; the stored
    trace or mu is bf16 (Adam's nu f32) and equals optax's state exactly,
    and the state exported under JAX's keypaths has optax's key set. A port
    that rounded at another point (no rounding of the decayed moment, or
    an f32 decay) is ~1e-3 off here."""
    from cape_tpu.train.checkpoint import flatten_tree
    from cape_tpu.train.optim import build_optimizer
    from cape_tpu_torch.train.optim import Optimizer

    ctxs, _ = setup
    kw = dict(TINY, optimizer=optimizer, opt_state_dtype="bfloat16")
    model = _model(CAPEConfig(**kw), ctxs["float32"][1])
    params = _jax_tree(model)
    tx, _, _ = build_optimizer(JaxConfig(**kw), steps_per_epoch=3)
    jstate = tx.init(params)
    opt = Optimizer(CAPEConfig(**kw), steps_per_epoch=3)
    rng = np.random.default_rng(5)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    for _ in range(3):
        grads = {k: (0.01 * rng.standard_normal(s) / np.sqrt(np.prod(s))).astype(np.float32)
                 for k, s in shapes.items()}
        jup, jstate = tx.update(_nest(grads), jstate, params)
        want = _flat(jup)
        got = opt.update({k: torch.from_numpy(g) for k, g in grads.items()})
        for k, w in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max() + 1e-30, err_msg=k)
    slot = "trace" if optimizer == "sgd" else "mu"
    for bufs in opt.buffers.values():
        assert bufs[slot].dtype == torch.bfloat16
        if optimizer == "adam":
            assert bufs["nu"].dtype == torch.float32
    jflat = {k: v for k, v in flatten_tree(jstate).items()}
    mine = opt.state_arrays(dict(model.named_parameters()))
    assert sorted(mine) == sorted(".opt_state" + k for k in jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(mine[".opt_state" + k], v, err_msg=k)


def _jax_step_fn(jcfg, jctx, tx):
    from cape_tpu.train.optim import TrainState
    from cape_tpu.train.step import _gan_losses

    jmodel = EpsCAPE(jcfg)

    @jax.jit
    def step_fn(state, batch, eps):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: _gan_losses(jmodel, jcfg, p, jctx, batch, eps), has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype), state.params, updates)
        return TrainState(step=state.step + 1, params=new, opt_state=opt_state), metrics

    return step_fn


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_resumes_in_the_other_package(setup, tmp_path, writer, optimizer):
    """Two steps in one package, a checkpoint of its whole train state, and
    the other package's restore_latest: every leaf (parameters, optimizer
    state under JAX's keypaths, step) restores exactly, and one more step
    from each package's restored state agrees (metrics 1e-4 relative,
    parameters after the step within 1e-3 * max|update| of the leaf)."""
    from cape_tpu.train import checkpoint as jckpt
    from cape_tpu.train.optim import build_optimizer, create_train_state
    from cape_tpu_torch.train import checkpoint as ckpt
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    ctxs, data = setup
    jctx, ctx = ctxs["float32"]
    kw = dict(TINY, optimizer=optimizer)
    cfg, jcfg = CAPEConfig(**kw), JaxConfig(**kw)
    spe = len(data.disp_train) // B
    batches = _batches(data, ctx.perm0, 3)
    eps = np.random.default_rng(3).standard_normal((3, B, cfg.nz)).astype(np.float32)
    tb = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    tx, _, _ = build_optimizer(jcfg, spe)
    jstep = _jax_step_fn(jcfg, jctx, tx)
    state = TrainState(_model(cfg, ctx), Optimizer(cfg, spe))
    template = jax.device_get(create_train_state(_jax_tree(state.model), tx))
    d = str(tmp_path / "checkpoints")
    if writer == "port":
        for i in range(2):
            train_step(state, ctx, tb(batches[i]), torch.from_numpy(eps[i]))
        path = ckpt.save_checkpoint(d, state, state.step)
        jstate, jpath = jckpt.restore_latest(d, template)
        assert jpath == path
    else:
        jstate = create_train_state(_jax_tree(state.model), tx)
        for i in range(2):
            jstate, _ = jstep(jstate, jb(batches[i]), jnp.asarray(eps[i]))
        path = jckpt.save_checkpoint(d, jax.device_get(jstate), step=2)
        assert ckpt.restore_latest(d, state) == path
    want = jckpt.flatten_tree(jax.device_get(jstate))
    got = ckpt.flatten_state(state)
    assert sorted(got) == sorted(want) and state.step == int(jstate.step) == 2
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    m, _ = train_step(state, ctx, tb(batches[2]), torch.from_numpy(eps[2]))
    jstate, jm = jstep(jstate, jb(batches[2]), jnp.asarray(eps[2]))
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    after_j = _flat(jax.device_get(jstate.params))
    for k, p in state.model.state_dict().items():
        dj = after_j[k] - before[k].numpy()
        np.testing.assert_allclose(p.numpy(), after_j[k], rtol=0,
                                   atol=1e-3 * np.abs(dj).max() + 1e-30, err_msg=k)


def test_restore_latest_falls_back_past_a_torn_file_and_raises_on_a_mismatch(setup, tmp_path):
    """A torn newest checkpoint is skipped with a RuntimeWarning naming it and
    the next one restores; an intact checkpoint of another configuration
    raises CheckpointMismatchError naming the first key that does not fit,
    with no fallback, and leaves the state untouched; an empty directory
    restores nothing."""
    from cape_tpu_torch.train import checkpoint as ckpt
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState

    ctxs, _ = setup
    ctx = ctxs["float32"][1]
    cfg = CAPEConfig(**TINY)
    d = str(tmp_path)
    assert ckpt.restore_latest(d, TrainState(_model(cfg, ctx), Optimizer(cfg, 3))) is None
    written = TrainState(_model(cfg, ctx, seed=1), Optimizer(cfg, 3), step=4)
    good = ckpt.save_checkpoint(d, written, 4)
    torn = ckpt.save_checkpoint(d, written, 5)
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    state = TrainState(_model(cfg, ctx), Optimizer(cfg, 3))
    with pytest.warns(RuntimeWarning, match="ckpt_0000000005.npz is unreadable"):
        assert ckpt.restore_latest(d, state) == good
    assert state.step == 4
    for k, v in written.model.state_dict().items():
        torch.testing.assert_close(state.model.state_dict()[k], v, rtol=0, atol=0)
    other = CAPEConfig(**dict(TINY, nz=16))
    ckpt.save_checkpoint(d, TrainState(_model(other, ctx), Optimizer(other, 3), step=6), 6)
    fresh = TrainState(_model(cfg, ctx), Optimizer(cfg, 3))
    want = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ckpt.CheckpointMismatchError,
                           match=r"\['fc_mean'\]\['kernel'\]\" has shape"):
            ckpt.restore_latest(d, fresh)
    assert fresh.step == 0
    for k, v in want.items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0, atol=0)


def _fit(setup, tmp_path, **change):
    from cape_tpu_torch.train.loop import Trainer

    ctxs, data = setup
    ctx = ctxs["bfloat16"][1]
    cfg = CAPEConfig(**{**TINY, "compute_dtype": "bfloat16", "opt_state_dtype": "bfloat16",
                        "steps_per_dispatch": 2, **change})
    trainer = Trainer(cfg, _model(cfg, ctx), ctx, data, workdir=str(tmp_path))
    trainer.fit()
    return trainer


def test_resume_is_bit_equal_to_the_uninterrupted_run(setup, tmp_path):
    """bf16 compute and bf16 optimizer state: a 2-epoch run, and a 1-epoch
    run resumed with restart=False for 1 more, end with bit-equal
    checkpoints (every parameter, moment, count and the step). The resumed
    run appends to metrics.jsonl (epoch 1 of each run), logs lr_g at the
    restored count, writes TensorBoard events with the loss scalars and
    each checkpoint's parameter histograms (under the JAX package's tags),
    a profiler trace of profile_steps steps, and the dashboard."""
    from cape_tpu_torch.train.checkpoint import latest_checkpoint
    from cape_tpu_torch.train.tb_events import read_events

    whole = _fit(setup, tmp_path / "whole", num_epochs=2)
    _fit(setup, tmp_path / "split")
    split = _fit(setup, tmp_path / "split", restart=False, profile_steps=2)
    spe = whole.steps_per_epoch
    assert whole.state.step == split.state.step == 2 * spe
    a, b = latest_checkpoint(whole.ckpt_dir), latest_checkpoint(split.ckpt_dir)
    assert os.path.basename(a) == os.path.basename(b) == f"ckpt_{2 * spe:010d}.npz"
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert any(".opt_state" in k for k in za.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with open(os.path.join(split.run_dir, "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "epoch" in r]
    assert [(r["epoch"], r["step"]) for r in epochs] == [(1, spe - 1), (1, 2 * spe - 1)]
    assert epochs[1]["lr_g"] == pytest.approx(float(split.state.tx.sched["g"](2 * spe - 1)))
    events = [e for p in sorted(glob.glob(os.path.join(split.run_dir, "events.out.tfevents.*")))
              for e in read_events(p)]
    scalars = [e for e in events if "train/loss_g" in e["scalars"]]
    assert [e["step"] for e in scalars] == [spe - 1, 2 * spe - 1]
    hist_steps = {e["step"] for e in events
                  if "params/generator/decoder/fc1/kernel" in e["histograms"]}
    assert hist_steps == {spe, 2 * spe}
    with open(os.path.join(split.run_dir, "profile", "trace.json")) as f:
        trace = json.load(f)
    assert any("train_step" in str(ev.get("name", "")) or "aten::" in str(ev.get("name", ""))
               for ev in trace["traceEvents"])
    assert os.path.isfile(os.path.join(split.run_dir, "metrics.html"))
