"""Parity of the PyTorch port's training path with the JAX package on the
CPU: the discriminator, the GAN train step over three steps (metrics and
per-leaf updates, with the kernel route taken in both packages), the
per-player gradient blocking, the Trainer and its checkpoints, and the
train-mode entry point. The icosphere model is the flagship family cut to
4 layers, nf=8, batch 4; parameters come from the port's seed-0 init
through the bridge, inputs and the reparameterization noise from numpy."""

import json
import os

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

torch.set_num_threads(1)

B = 4
TINY = dict(
    name="torch_train_test", num_conv_layers=4, nf=8, nz=8, nz_cond=8, nz_cond2=4,
    use_res_block=False, use_res_block_dec=True, affine=True, reduce_dim=4,
    batch_size=B, num_epochs=1,
)


class EpsCAPE(JaxCAPE):
    """The JAX model with the reparameterization noise given by the caller:
    the `rng` argument of generate (and of the train step) carries eps."""

    def sample_z(self, rng, z_mean, z_logvar):
        return z_mean + jnp.exp(0.5 * jnp.clip(z_logvar, -30.0, 30.0)) * rng


@pytest.fixture(scope="module")
def setup(small_mesh):
    """Both packages' contexts of the icosphere pyramids (padded layout) and
    the synthetic data, in the port's banded vertex order."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, CAPEConfig(**TINY).ds_factors)
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    edges = vertices_per_edge(faces, len(verts))
    jctx = jax_context(pyr, pyr_d, edges, verts, padded=True)
    ctx = build_graph_context(pyr, pyr_d, edges, verts, padded=True)
    data = synthetic_bodydata(n_train=32, n_test=6, num_verts=len(verts), seed=0, n_val=8)
    return jctx, ctx, data


@pytest.fixture
def kernel_route(monkeypatch):
    """The large-batch route lowered to batch 4 in both packages: JAX runs
    Pallas v3 (interpret mode) in both directions, the port its
    band-apply plain version."""
    import cape_tpu.ops.cheb as jax_cheb
    from cape_tpu_torch.ops import cheb

    for mod in (jax_cheb, cheb):
        monkeypatch.setattr(mod, "VM_MIN_BATCH", B)
        monkeypatch.setattr(mod, "VM_MIN_COLS", B * 3)


def _model(cfg, ctx, seed=0):
    return CAPE(cfg).init_params(torch.Generator().manual_seed(seed), ctx)


def _jax_tree(model):
    return jax.tree_util.tree_map(jnp.asarray, to_jax_params(model))


def _batch(data, perm, ig, idd):
    disp = data.disp_train[:, perm]
    return {
        "disp_g": disp[ig], "pose_g": data.pose_train[ig], "clo_g": data.clo_train[ig],
        "disp_d": disp[idd], "pose_d": data.pose_train[idd], "clo_d": data.clo_train[idd],
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_discriminate_matches_jax(setup, kernel_route):
    """discriminate's logits, and the gradients of a random projection of
    them with respect to x and every discriminator parameter, against JAX,
    f32, 1e-4 * max|ref|. The pred conv takes the kernel route here."""
    from cape_tpu_torch.ops import kernels

    jctx, ctx, _ = setup
    cfg = CAPEConfig(**TINY)
    model = _model(cfg, ctx)
    jmodel, params = JaxCAPE(JaxConfig(**TINY)), _jax_tree(model)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, ctx.level_sizes[0], 3)).astype(np.float32)
    y = rng.standard_normal((B, cfg.nz_cond)).astype(np.float32)
    y2 = rng.standard_normal((B, cfg.nz_cond2)).astype(np.float32)
    w = rng.standard_normal((B, ctx.level_sizes_d[-1], 1)).astype(np.float32)

    def jloss(params, x):
        d = jmodel.discriminate(params, jctx, x, jnp.asarray(y), jnp.asarray(y2))
        return jnp.sum(d * w), d

    (_, want_d), (want_gp, want_gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    routes = kernels.counts["route.v3"]
    d = model.discriminate(ctx, xt, torch.from_numpy(y), torch.from_numpy(y2))
    assert kernels.counts["route.v3"] - routes == 1  # the pred conv
    disc = dict(model.discriminator.named_parameters())
    grads = torch.autograd.grad((d * torch.from_numpy(w)).sum(), [xt, *disc.values()])
    got = {"d": d, "dx": grads[0]} | {f"d/{k}": g for k, g in zip(disc, grads[1:])}
    want = {"d": want_d, "dx": want_gx} | {
        f"d/{k}": v for k, v in _flat(want_gp["discriminator"]).items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got[k].detach().numpy(), v, rtol=0,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)
    # detached parameters: the same values (to f32 rounding: BLAS may take
    # another path), no gradient to them
    dd = model.discriminate(ctx, xt, torch.from_numpy(y), torch.from_numpy(y2), detach_params=True)
    torch.testing.assert_close(dd, d, rtol=0, atol=1e-5 * float(d.detach().abs().max()))
    g = torch.autograd.grad(dd.sum(), [xt, *disc.values()], allow_unused=True)
    assert g[0] is not None and all(t is None for t in g[1:])


def test_train_step_matches_jax_over_three_steps(setup, kernel_route):
    """Three GAN train steps of the port (train_step) and of JAX's jitted
    build_train_step, from the same parameters, batches and eps: the eight
    metrics of every step within 1e-4 relative, and every leaf's update
    (p_after - p_before) within 1e-3 * max|update_jax| of the leaf. SGD
    with momentum, no warmup, so every step moves every player."""
    from cape_tpu.train.optim import build_optimizer, create_train_state
    from cape_tpu.train.step import build_train_step
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    jctx, ctx, data = setup
    cfg = CAPEConfig(**TINY)
    jcfg = JaxConfig(**TINY)
    model = _model(cfg, ctx)
    spe = len(data.disp_train) // B
    tx, _, _ = build_optimizer(jcfg, steps_per_epoch=spe)
    jstate = create_train_state(_jax_tree(model), tx)
    jstep = jax.jit(build_train_step(EpsCAPE(jcfg), jcfg, tx))
    state = TrainState(model, Optimizer(cfg, spe))

    sg, sd = BatchStream(len(data.disp_train), B, 0), BatchStream(len(data.disp_train), B, 1)
    rng = np.random.default_rng(9)
    for step in range(3):
        batch = _batch(data, ctx.perm0, sg.next_indices(), sd.next_indices())
        eps = rng.standard_normal((B, cfg.nz)).astype(np.float32)
        before_j = _flat(jax.device_get(jstate.params))
        jstate, jm = jstep(jstate, jctx, {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(eps))
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        m, updates = train_step(state, ctx, {k: torch.from_numpy(v) for k, v in batch.items()},
                                torch.from_numpy(eps))
        assert m.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=f"{step} {k}")
        after_j = _flat(jax.device_get(jstate.params))
        after = model.state_dict()
        assert after.keys() == after_j.keys()
        for k in after_j:
            dj = after_j[k] - before_j[k]
            dp = (after[k] - before[k]).numpy()
            assert np.abs(dj).max() > 0, f"step {step}: {k} did not move"
            np.testing.assert_allclose(dp, dj, rtol=0, atol=1e-3 * np.abs(dj).max(),
                                       err_msg=f"step {step} {k}")
            # the returned update is what was added (up to p's rounding)
            np.testing.assert_allclose(updates[k].numpy(), dp, rtol=0,
                                       atol=2 * np.spacing(np.abs(after[k].numpy()).max()))
    assert state.step == 3 and int(jstate.step) == 3


def _plain_two_player(model, cfg, ctx, batch, eps):
    """loss_g and loss_d without gradient blocking: D sees x_hat and the
    embeddings live, G sees D's live parameters (JAX's _forward_losses)."""
    from cape_tpu_torch import losses

    y_g, y2_g = model.embed_conditions(batch["pose_g"], batch["clo_g"])
    y_d, y2_d = model.embed_conditions(batch["pose_d"], batch["clo_d"])
    x_hat, zm, zl, _ = model.generate(ctx, batch["disp_g"], y_g, y2_g, eps)
    d_real = model.discriminate(ctx, batch["disp_d"], y_d, y2_d)
    d_fake = model.discriminate(ctx, x_hat, y_g, y2_g)
    gt = batch["disp_g"]
    loss_g = (
        cfg.lambda_gan * losses.gan_generator_loss(d_fake)
        + cfg.lambda_recon * losses.reconstruction_loss(x_hat, gt, kind=cfg.loss)
        + cfg.lambda_edge * losses.edge_loss(x_hat, gt, ctx.edge_op)
        + cfg.lambda_latent * losses.kl_loss(zm, zl)
        + losses.regularization_scale(cfg.regularization) * losses.generator_fc_l2(model.params)
    )
    return loss_g, cfg.lambda_gan * losses.gan_discriminator_loss(d_real, d_fake)


def test_single_backward_matches_stitched_two_player_grads(setup):
    """The gradient of the blocked loss_g + loss_d equals the gradient of
    the plain loss_g on the generator and condition nets, and of the plain
    loss_d on the discriminator (a missed detach trains, but wrongly)."""
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.train.step import gan_losses

    _, ctx, data = setup
    cfg = CAPEConfig(**TINY)
    model = _model(cfg, ctx, seed=3)
    n = len(data.disp_train)
    batch = _batch(data, ctx.perm0, BatchStream(n, B, 0).next_indices(),
                   BatchStream(n, B, 1).next_indices())
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    eps = torch.from_numpy(np.random.default_rng(1).standard_normal((B, cfg.nz)).astype(np.float32))
    named = dict(model.named_parameters())
    total, _ = gan_losses(model, cfg, ctx, batch, eps)
    blocked = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    loss_g, loss_d = _plain_two_player(model, cfg, ctx, batch, eps)
    g_names = [k for k in named if not k.startswith("discriminator.")]
    d_names = [k for k in named if k.startswith("discriminator.")]
    want = dict(zip(g_names, torch.autograd.grad(loss_g, [named[k] for k in g_names],
                                                 retain_graph=True)))
    want |= dict(zip(d_names, torch.autograd.grad(loss_d, [named[k] for k in d_names])))
    assert want.keys() == blocked.keys()
    for k, w in want.items():
        assert w.abs().max() > 0, k
        torch.testing.assert_close(blocked[k], w, rtol=1e-5, atol=1e-6 * float(w.abs().max()),
                                   msg=k)


def test_trainer_fit_writes_a_checkpoint_jax_keys_read_bit_equal(setup, tmp_path):
    """A 1-epoch fit on the icosphere: the losses are finite, the val split
    is evaluated, metrics.jsonl has the epoch record, and the checkpoint
    (JAX keypath names) reads back through load_jax_checkpoint and
    restore_params bit-equal to the trained parameters."""
    from cape_tpu_torch.apps.main import restore_params
    from cape_tpu_torch.core.bridge import load_jax_checkpoint
    from cape_tpu_torch.train.checkpoint import latest_checkpoint
    from cape_tpu_torch.train.loop import Trainer

    _, ctx, data = setup
    cfg = CAPEConfig(**TINY, steps_per_dispatch=2)
    model = _model(cfg, ctx)
    trainer = Trainer(cfg, model, ctx, data, workdir=str(tmp_path))
    val_losses, _ = trainer.fit()
    assert trainer.num_steps == len(data.disp_train) // B == trainer.state.step
    assert len(val_losses) == 1 and np.isfinite(val_losses[0])
    path = latest_checkpoint(trainer.ckpt_dir)
    assert os.path.basename(path) == f"ckpt_{trainer.num_steps:010d}.npz"
    with np.load(path) as z:
        assert int(z[".step"]) == trainer.num_steps
        assert ".params['generator']['decoder']['fc1']['kernel']" in z.files
    sd = load_jax_checkpoint(path)
    want = model.state_dict()
    assert sd.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0, msg=k)
    restored = restore_params(cfg, CAPE(cfg), ctx, str(tmp_path))
    for k, v in restored.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    with open(os.path.join(trainer.run_dir, "metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f][-1]
    assert rec["epoch"] == 1 and np.isfinite(rec["loss_g"]) and np.isfinite(rec["val_recon"])
    test = trainer.evaluate("test")
    assert set(test) == {"recon", "kl", "edge"} and all(np.isfinite(list(test.values())))


def test_fit_fails_fast_on_non_finite_loss(setup, tmp_path):
    """A NaN in the data stops the fit at the first screen, naming the step."""
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.train.loop import Trainer

    _, ctx, _ = setup
    data = synthetic_bodydata(n_train=16, n_test=4, num_verts=ctx.level_sizes[0], seed=1, n_val=4)
    data.disp_train[:] = np.nan
    cfg = CAPEConfig(**TINY, steps_per_dispatch=1)
    trainer = Trainer(cfg, _model(cfg, ctx), ctx, data, workdir=str(tmp_path))
    with pytest.raises(FloatingPointError, match="non-finite training loss at step 0"):
        trainer.fit()


@pytest.mark.parametrize("change", [{"mode": "test"}, {"mode": "demo"}])
def test_unported_modes_raise(change, tmp_path, monkeypatch):
    """--mode test|demo restore a trained run: without a checkpoint under
    <workdir>/<name>/checkpoints, run() and the CLI raise FileNotFoundError
    naming the mode and the directory, before anything is built.
    (tests/test_torch_demos.py runs both modes with a checkpoint.)"""
    from cape_tpu_torch.apps import main as app_main

    built = []
    monkeypatch.setattr(app_main, "build_context", lambda *a, **k: built.append(1))
    with pytest.raises(FileNotFoundError, match=f"--mode {change['mode']} restores"):
        app_main.run(CAPEConfig(**TINY, **change), str(tmp_path))
    with pytest.raises(FileNotFoundError, match=f"--mode {change['mode']}.*checkpoints"):
        app_main.main(["--name", "x", "--mode", change["mode"], "--device", "cpu",
                       "--workdir", str(tmp_path)])
    assert not built


@pytest.mark.parametrize("change", [{"data_parallel": 2}])
def test_unported_trainer_options_raise(setup, change, tmp_path):
    """data_parallel=2, once refused as not ported, is ported: without a
    process group the Trainer drives its one device, so asking for two
    raises the over-request ValueError (tests/test_torch_parallel.py runs
    it over a group)."""
    from cape_tpu_torch.train.loop import Trainer

    _, ctx, data = setup
    cfg = CAPEConfig(**TINY, **change)
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 1 devices"):
        Trainer(cfg, _model(CAPEConfig(**TINY), ctx), ctx, data, workdir=str(tmp_path))


@pytest.mark.parametrize("kind", ["l1", "huber", "l2"])
def test_losses_match_jax(setup, kind):
    """Every ported loss against cape_tpu.losses, f32, 1e-6 relative:
    reconstruction with and without a mask, KL (with a logvar past the exp
    clamp), edge loss through the edge operator and through the index
    table, both GAN losses, and the FC-kernel regularizer."""
    from cape_tpu import losses as jl
    from cape_tpu_torch import losses as tl

    jctx, ctx, _ = setup
    rng = np.random.default_rng(4)
    V = ctx.level_sizes[0]
    pred, gt = (0.1 * rng.standard_normal((2, B, V, 3))).astype(np.float32)
    mask = rng.uniform(0, 2, V).astype(np.float32)
    zm = rng.standard_normal((B, 8)).astype(np.float32)
    zl = (rng.standard_normal((B, 8)) * 20).astype(np.float32)
    zl[0, 0] = 45.0  # past the clamp
    d1, d2 = rng.standard_normal((2, B, 17, 1)).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        (tl.reconstruction_loss_per_sample(t(pred), t(gt), None, kind),
         jl.reconstruction_loss_per_sample(j(pred), j(gt), None, kind)),
        (tl.reconstruction_loss_per_sample(t(pred), t(gt), t(mask), kind),
         jl.reconstruction_loss_per_sample(j(pred), j(gt), j(mask), kind)),
        (tl.reconstruction_loss(t(pred), t(gt), t(mask), kind),
         jl.reconstruction_loss(j(pred), j(gt), j(mask), kind)),
        (tl.kl_loss_per_sample(t(zm), t(zl)), jl.kl_loss_per_sample(j(zm), j(zl))),
        (tl.kl_loss(t(zm), t(zl)), jl.kl_loss(j(zm), j(zl))),
        (tl.edge_loss_per_sample(t(pred), t(gt), ctx.edge_op),
         jl.edge_loss_per_sample(j(pred), j(gt), jctx.edge_op)),
        (tl.edge_loss(t(pred), t(gt), ctx.edge_op), jl.edge_loss(j(pred), j(gt), jctx.edge_op)),
        (tl.edge_loss_indexed(t(pred), t(gt), ctx.edges),
         jl.edge_loss_indexed(j(pred), j(gt), jctx.edges)),
        (tl.gan_generator_loss(t(d1)), jl.gan_generator_loss(j(d1))),
        (tl.gan_discriminator_loss(t(d1), t(d2)), jl.gan_discriminator_loss(j(d1), j(d2))),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0, err_msg=str(i))
    model = _model(CAPEConfig(**TINY), ctx)
    np.testing.assert_allclose(float(tl.generator_fc_l2(model.params).detach()),
                               float(jl.generator_fc_l2(_jax_tree(model))), rtol=1e-6)
    assert tl.regularization_scale(2e-3) == jl.regularization_scale(2e-3)


@pytest.mark.parametrize(
    "change,grad_scale",
    [({}, 0.01), ({}, 10.0), ({"optimizer": "adam"}, 0.01), ({"optimizer": "adam"}, 10.0),
     ({"optim_condnet": False}, 10.0), ({"lr_warmup": True}, 10.0)],
    ids=["sgd-noclip", "sgd-clip", "adam-noclip", "adam-clip", "frozen-condnet", "warmup"],
)
def test_optimizer_matches_optax(setup, change, grad_scale):
    """Two successive updates of the port's Optimizer against the JAX
    package's build_optimizer (optax) on the same gradients, per leaf,
    within 1e-5 relative of the leaf's largest update: SGD momentum and
    Adam, each player's global-norm clip inactive (norm < 5) and active,
    frozen condition nets, and the warmup's zero first lr."""
    from cape_tpu.train.optim import build_optimizer
    from cape_tpu_torch.train.optim import Optimizer

    _, ctx, _ = setup
    cfg = CAPEConfig(**dict(TINY, **change))
    model = _model(cfg, ctx)
    params = _jax_tree(model)
    tx, _, _ = build_optimizer(JaxConfig(**dict(TINY, **change)), steps_per_epoch=3)
    jstate = tx.init(params)
    opt = Optimizer(cfg, steps_per_epoch=3)
    rng = np.random.default_rng(5)
    names = list(model.state_dict())
    for _ in range(2):
        grads = {k: (grad_scale * rng.standard_normal(v.shape) / np.sqrt(v.numel()))
                 .astype(np.float32) for k, v in model.state_dict().items()}
        tree = {}
        for k, g in grads.items():
            node = tree
            *parents, leaf = k.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(g)
        jup, jstate = tx.update(tree, jstate, params)
        want = _flat(jup)
        got = opt.update({k: torch.from_numpy(g) for k, g in grads.items()})
        assert sorted(got) == sorted(want) == sorted(names)
        for k in names:
            w = want[k]
            if change.get("optim_condnet") is False and k.startswith("cond_"):
                assert not np.any(w) and not torch.any(got[k])
                continue
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max() + 1e-30, err_msg=k)


@pytest.mark.parametrize("warmup", [0, 24])
def test_schedule_matches_jax(warmup):
    """cape_schedule at every step of a warmup and three decay stairs,
    float32, against the JAX schedule (1e-7 relative)."""
    from cape_tpu.train.schedules import cape_schedule as jax_schedule
    from cape_tpu_torch.train.schedules import cape_schedule

    mine, ref = cape_schedule(8e-3, 6, 0.9, warmup), jax_schedule(8e-3, 6, 0.9, warmup)
    steps = np.arange(warmup + 20)
    got = np.array([mine(s) for s in steps], np.float32)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    if warmup:
        assert got[0] == 0.0


@pytest.mark.parametrize("pose_type", ["rot", "pose"])
def test_synthetic_bodydata_matches_jax(pose_type):
    """synthetic_bodydata of the port equals the JAX package's, every array
    of every split and the normalization stats (1e-6 relative)."""
    from cape_tpu.data.synthetic import synthetic_bodydata as jax_synth
    from cape_tpu_torch.data.synthetic import synthetic_bodydata

    kw = dict(n_train=40, n_test=8, num_verts=300, seed=7, n_val=6, pose_type=pose_type)
    a, b = synthetic_bodydata(**kw), jax_synth(**kw)
    names = [f"{k}_{s}" for k in ("disp", "pose", "clo") for s in ("train", "val", "test")]
    for name in names + ["mean", "std", "pose_train_full", "pose_test_full"]:
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape and x.dtype == y.dtype, name
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6 * np.abs(y).max(), err_msg=name)


def test_bodydata_from_packed_and_batch_streams_match_jax(tmp_path):
    """BodyData.from_packed reads a packed directory as JAX does, and
    BatchStream gives JAX's index sequence across epoch boundaries."""
    from cape_tpu.data.loader import BatchStream as JaxStream
    from cape_tpu.data.loader import BodyData as JaxData
    from cape_tpu_torch.data.loader import BatchStream, BodyData

    rng = np.random.default_rng(2)
    for phase, n in (("train", 30), ("test", 5)):
        os.makedirs(tmp_path / phase)
        np.save(tmp_path / phase / f"{phase}_disp.npy", rng.standard_normal((n, 50, 3)))
        np.save(tmp_path / phase / f"{phase}_rot.npy", rng.standard_normal((n, 216)))
        np.save(tmp_path / phase / f"{phase}_clo_label.npy", np.eye(4)[rng.integers(0, 4, n)])
    a = BodyData.from_packed(str(tmp_path), n_val=7)
    b = JaxData.from_packed(str(tmp_path), n_val=7)
    for name in ("disp_train", "disp_val", "pose_train", "pose_test", "clo_val", "mean", "std"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    for n, bs, seed in ((23, 4, 0), (24, 8, 1), (5, 7, 123)):
        s, js = BatchStream(n, bs, seed), JaxStream(n, bs, seed)
        for _ in range(9):
            np.testing.assert_array_equal(s.next_indices(), js.next_indices())


def test_eval_step_matches_jax(setup, kernel_route):
    """eval_step's prediction and per-sample recon/kl/edge against the JAX
    package's build_eval_step on the same batch and eps, f32, 1e-4 *
    max|ref| (prediction) and 1e-5 relative (metrics)."""
    from cape_tpu.train.step import build_eval_step
    from cape_tpu_torch.train.step import eval_step

    jctx, ctx, data = setup
    cfg = CAPEConfig(**TINY)
    model = _model(cfg, ctx)
    disp, pose, clo = (a[:B] for a in data.split("val"))
    batch = {"disp": disp[:, ctx.perm0], "pose": pose, "clo": clo}
    eps = np.random.default_rng(8).standard_normal((B, cfg.nz)).astype(np.float32)
    jfn = jax.jit(build_eval_step(EpsCAPE(JaxConfig(**TINY)), JaxConfig(**TINY)))
    jpred, jm = jfn(_jax_tree(model), jctx, {k: jnp.asarray(v) for k, v in batch.items()},
                    jnp.asarray(eps))
    pred, m = eval_step(model, cfg, ctx, {k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.from_numpy(eps))
    jpred = np.asarray(jpred)
    np.testing.assert_allclose(pred.numpy(), jpred, rtol=0, atol=1e-4 * np.abs(jpred).max())
    assert m.keys() == jm.keys()
    for k in jm:
        assert m[k].shape == (B,) and m[k].dtype == torch.float32
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-5, err_msg=k)


def test_evaluate_drops_tail_padding(setup, tmp_path):
    """Trainer.evaluate over a split of 6 rows at batch 4 (a tail batch of
    2 real rows and 2 zero rows) averages the real rows only: it equals
    the mean of eval_step's per-sample metrics over unpadded batches with
    the same noise (JAX's eval noise under fold_in(PRNGKey(seed), key))."""
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.train.loop import Trainer, eval_noise
    from cape_tpu_torch.train.step import eval_step

    _, ctx, data = setup
    cfg = CAPEConfig(**TINY)
    model = _model(cfg, ctx)
    trainer = Trainer(cfg, model, ctx, data, workdir=str(tmp_path))
    got = trainer.evaluate("test", key=5)
    disp, pose, clo = data.split("test")
    assert len(disp) == 6
    per = {}
    for begin in (0, 4):
        rows = slice(begin, min(begin + B, 6))
        batch = {"disp": torch.from_numpy(disp[rows][:, ctx.perm0]),
                 "pose": torch.from_numpy(pose[rows]), "clo": torch.from_numpy(clo[rows])}
        key = prng.fold_in(prng.PRNGKey(cfg.seed), 5)
        eps = eval_noise(key, begin, (B, cfg.nz), "cpu")[: rows.stop - begin]
        _, m = eval_step(model, cfg, ctx, batch, eps)
        for k, v in m.items():
            per.setdefault(k, []).append(v.double())
    for k, v in per.items():
        np.testing.assert_allclose(got[k], float(torch.cat(v).mean()), rtol=1e-6, err_msg=k)
