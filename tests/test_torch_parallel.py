"""Data parallelism in the PyTorch port, on the CPU: the device mesh, one
global train step and a Trainer.fit over 2 Gloo ranks (one OS process
each) against JAX's DataParallel(2) step on the virtual CPU devices and
against the port's single-process run, the multihost selftest, the
engine over two devices, and `apps.main --data_parallel 2`.

The model is the multihost selftest's (`parallel.multihost._tiny`: the
icosphere(3) model at nf=4, global batch 16, 8 rows a rank). The ranks run
this file as a script (`python tests/test_torch_parallel.py worker ...`),
each with one thread and a timeout of its own, and are killed on timeout.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cape_tpu_torch.models.cape import CAPE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 2
STEPS = 2
# the seeded fit: 3 steps an epoch (48 train rows at global batch 16) in
# dispatch chunks of 2, so that a chunk ends mid-epoch
SEEDED = dict(num_epochs=2, steps_per_dispatch=2, tensorboard=False)
RANK_TIMEOUT = 300   # seconds a spawned rank may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argv_of_rank, timeout=RANK_TIMEOUT) -> list[str]:
    """Run N_RANKS processes (argv_of_rank(rank, port) each, from the repo
    root), wait for all with a timeout, kill any left; every rank must exit
    0. Returns their standard outputs."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv_of_rank(rank, port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(N_RANKS)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:   # no rank outlives the test
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err[-3000:]}"
    return [out for out, _ in outs]


def _setup(name="dp_test", **overrides):
    from cape_tpu_torch.parallel.multihost import _tiny

    return _tiny(name, N_RANKS, **overrides)


def _model(cfg, ctx):
    """The tiny model's parameters in the test form (`core.params`:
    torch.Generator seed 0), which these tests hold the ranks to the single
    process and to JAX on. (At JAX's PRNGKey(0) parameters the residual-CMR
    variant's step 2 is ill-conditioned: moving every parameter by one ulp
    moves a gradient leaf by up to 8% in one process, beyond the 1e-3 step
    tolerance.)"""
    return CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)


def _inputs(cfg, ctx, data):
    """STEPS global batches (the G and D index streams, seeds 0 and 1) and
    the global noise [STEPS, B, nz]."""
    from cape_tpu_torch.data.loader import BatchStream

    n = len(data.disp_train)
    sg, sd = BatchStream(n, cfg.batch_size, 0), BatchStream(n, cfg.batch_size, 1)
    disp = data.disp_train[:, ctx.perm0]
    batches = []
    for _ in range(STEPS):
        ig, idd = sg.next_indices(), sd.next_indices()
        batches.append({"disp_g": disp[ig], "pose_g": data.pose_train[ig],
                        "clo_g": data.clo_train[ig], "disp_d": disp[idd],
                        "pose_d": data.pose_train[idd], "clo_d": data.clo_train[idd]})
    eps = np.random.default_rng(7).standard_normal((STEPS, cfg.batch_size, cfg.nz))
    return batches, eps.astype(np.float32)


def _port_steps(cfg, ctx, batches, eps, dp=None):
    """The port's STEPS train steps on this process's rows (all of them
    without `dp`): (metrics per step, reduced over the ranks; the last
    step's updates)."""
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    model = _model(cfg, ctx)
    lo, hi = (0, cfg.batch_size) if dp is None else dp.local_rows(cfg.batch_size)
    state = TrainState(model if dp is None else dp.replicate(model), Optimizer(cfg, 10))
    out = []
    for batch, e in zip(batches, eps):
        m, updates = train_step(state, ctx, {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
                                             for k, v in batch.items()},
                                torch.from_numpy(e[lo:hi]),
                                reduce=None if dp is None else dp.all_reduce_mean)
        if dp is not None:
            m = dp.all_reduce_mean(m)
        out.append({k: float(v) for k, v in m.items()})
    return out, {k: v.numpy() for k, v in updates.items()}


# ------------------------------------------------------------------- ranks
def _worker(mode: str, out: str, rank: int, n: int, port: int) -> None:
    """One rank: `step` (STEPS train steps on the inputs in <out>.inputs.npz),
    `fit` (a 2-epoch Trainer.fit in <out>.workdir) or `seeded` (SEEDED's fit
    from JAX's PRNGKey(cfg.seed) parameters, recording the noise each step
    received); writes <out>.<rank>.npz and prints the rank's reduced
    metrics."""
    import torch.distributed as dist

    from cape_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", n, rank, backend="gloo")
    try:
        mh = multihost.MultiHostDataParallel(torch.device("cpu"))
        if mode == "step":
            cfg, ctx, _ = _setup()
            with np.load(out + ".inputs.npz") as f:
                eps = f["eps"]
                batches = [{k.split("/")[1]: f[k] for k in f.files if k.startswith(f"{i}/")}
                           for i in range(STEPS)]
            metrics, updates = _port_steps(cfg, ctx, batches, eps, mh)
            arrays = {f"update/{k}": v for k, v in updates.items()}
        else:
            from cape_tpu_torch.parallel.multihost import _model as tiny_model
            from cape_tpu_torch.train import loop

            if mode == "fit":
                cfg, ctx, data = _setup("dp_fit", num_epochs=2)
                model = _model(cfg, ctx)
            else:
                cfg, ctx, data = _setup("dp_seeded", **SEEDED)
                model = tiny_model(cfg, ctx, cfg.seed)
            seen, step = [], loop.train_step

            def recorded(state, ctx, batch, eps, **kw):
                seen.append(eps.numpy().copy())
                return step(state, ctx, batch, eps, **kw)

            loop.train_step = recorded
            trainer = loop.Trainer(cfg, model, ctx, data, workdir=out + ".workdir", dp=mh)
            val, _ = trainer.fit()
            metrics = [{"val_recon": float(v)} for v in val]
            arrays = {f"param/{k}": v.numpy() for k, v in trainer.model.state_dict().items()}
            arrays["step"] = np.array(trainer.state.step)
            arrays["eps"] = np.stack(seen)
            arrays["rows"] = np.array(mh.local_rows(cfg.batch_size))
        np.savez(f"{out}.{rank}.npz", **arrays)
        print("RANK " + json.dumps({"rank": rank, "metrics": metrics}), flush=True)
    finally:
        dist.destroy_process_group()


def _rank_records(outs) -> list[dict]:
    recs = [json.loads(re.search(r"RANK (\{.*\})", o).group(1)) for o in outs]
    assert sorted(r["rank"] for r in recs) == list(range(N_RANKS))
    return recs


# -------------------------------------------------------------------- tests
def test_make_mesh_sizes_and_the_over_request():
    """make_mesh takes the first n devices, the whole list by default (a
    device repeated is kept); asking for more than exist raises JAX's
    ValueError. This host has no GPU: its local devices are the CPU."""
    from cape_tpu_torch.parallel.mesh import DataParallel, local_devices, make_mesh

    cpu = torch.device("cpu")
    assert local_devices("cpu") == [cpu]
    if not torch.cuda.is_available():
        assert make_mesh() == [cpu] and local_devices() == [cpu]
        assert local_devices("cuda") == []
        with pytest.raises(ValueError, match="requested a 2-device mesh but only 1 devices"):
            make_mesh(2)
    four = [cpu] * 4
    assert make_mesh(devices=four) == four
    assert make_mesh(2, devices=four) == [cpu, cpu]
    with pytest.raises(ValueError, match="only 4 devices are available"):
        make_mesh(5, devices=four)
    dp = DataParallel(2, devices=four)
    assert dp.num_devices == 2 and dp.rank == 0 and dp.lead and dp.group is None
    with pytest.raises(ValueError, match="only"):
        DataParallel(3, devices=[cpu, cpu])


def test_local_rows_and_pad_batch_size():
    """JAX's pad_batch_size cases on an 8-device mesh; without a group the
    one process feeds every row (the ranks' shares are checked in the 2-rank
    runs below)."""
    from cape_tpu_torch.parallel.mesh import DataParallel

    dp = DataParallel(8, devices=[torch.device("cpu")] * 8)
    assert dp.pad_batch_size(16) == 16
    assert dp.pad_batch_size(17) == 24
    assert dp.pad_batch_size(1) == 8
    assert dp.local_rows(16) == (0, 16)
    x = {"a": torch.arange(6.0)}
    assert dp.all_reduce_mean(x) is x
    assert dp.all_gather_rows(x, 6)["a"].dtype == torch.float32
    assert dp.broadcast_ints([3, 4]) == [3, 4]


@pytest.fixture(scope="module")
def two_rank_step(tmp_path_factory):
    """STEPS global steps in 2 Gloo ranks, from the seed-0 parameters, on
    the inputs of `_inputs`: (cfg, ctx, batches, eps, per-rank metrics,
    rank 0's last updates)."""
    cfg, ctx, data = _setup()
    batches, eps = _inputs(cfg, ctx, data)
    out = str(tmp_path_factory.mktemp("dp_step") / "run")
    np.savez(out + ".inputs.npz", eps=eps,
             **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    outs = _spawn(lambda rank, port: [__file__, "worker", "step", out, str(rank),
                                      str(N_RANKS), str(port)])
    recs = _rank_records(outs)
    with np.load(out + ".0.npz") as f:
        updates = {k[len("update/"):]: f[k] for k in f.files}
    return cfg, ctx, batches, eps, recs, updates


def _hold(got_metrics, want_metrics, got_updates, want_updates, who):
    """Metrics within 1e-4 relative, each leaf's update within 1e-3 of its
    max|update| (the train step's tolerances against JAX)."""
    for i, (g, w) in enumerate(zip(got_metrics, want_metrics)):
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]) + 1e-7, f"{who} step {i + 1} {k}: {g[k]} {w[k]}"
    assert sorted(got_updates) == sorted(want_updates)
    for k, w in want_updates.items():
        scale = np.abs(w).max()
        np.testing.assert_allclose(got_updates[k], w, rtol=0, atol=1e-3 * scale + 1e-12,
                                   err_msg=f"{who} {k}")


def test_two_rank_step_matches_the_single_process_step(two_rank_step):
    """The 2-rank step (each rank its 8 rows, gradients averaged) gives the
    single-process step at the same global batch of 16: metrics and the
    step-2 updates (SGD momentum: step 2 carries step 1's gradient too);
    both ranks report the same reduced metrics."""
    cfg, ctx, batches, eps, recs, updates = two_rank_step
    assert recs[0]["metrics"] == recs[1]["metrics"]
    want, want_updates = _port_steps(cfg.replace(data_parallel=0), ctx, batches, eps)
    _hold(recs[0]["metrics"], want, updates, want_updates, "2 ranks vs 1 process")


def test_two_rank_step_matches_jax_data_parallel(two_rank_step):
    """The 2-rank step against JAX's DataParallel(2) step (a jit over the
    virtual CPU devices, the batch sharded, the gradient psum'd by XLA) from
    the same parameters, batches and eps."""
    import jax
    import jax.numpy as jnp

    from cape_tpu.core.config import CAPEConfig as JaxConfig
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.meshops.toy import icosphere
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu.ops.sparse import build_graph_context
    from cape_tpu.parallel.mesh import DataParallel as JaxDataParallel
    from cape_tpu.train.optim import TrainState, build_optimizer, create_train_state
    from cape_tpu.train.step import _gan_losses
    from cape_tpu_torch.core.bridge import _flatten, to_jax_params

    cfg, ctx, batches, eps, recs, updates = two_rank_step

    class EpsCAPE(JaxCAPE):
        def sample_z(self, rng, z_mean, z_logvar):
            return z_mean + jnp.exp(0.5 * jnp.clip(z_logvar, -30.0, 30.0)) * rng

    verts, faces = icosphere(3)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "name", "nf", "nz", "nz_cond", "nz_cond2", "use_res_block", "use_res_block_dec",
        "affine", "reduce_dim", "batch_size", "data_parallel")})
    jctx = build_graph_context(build_pyramid(verts, faces, jcfg.ds_factors),
                               build_pyramid(verts, faces, [2, 2, 2, 2]),
                               vertices_per_edge(faces, len(verts)), verts,
                               padded=jcfg.padded_layout)
    np.testing.assert_array_equal(jctx.vertex_perm, ctx.perm0)
    tx, _, _ = build_optimizer(jcfg, 10)
    jmodel = EpsCAPE(jcfg)

    def step_fn(state, c, batch, e):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: _gan_losses(jmodel, jcfg, p, c, batch, e), has_aux=True)(state.params)
        upd, opt_state = tx.update(grads, state.opt_state, state.params)
        new = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype), state.params, upd)
        return TrainState(step=state.step + 1, params=new, opt_state=opt_state), (metrics, upd)

    dp = JaxDataParallel(N_RANKS)
    fn = dp.compile_train_step(step_fn)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(_model(cfg, ctx)))
    state, c = dp.replicate(create_train_state(params, tx)), dp.replicate(jctx)
    want = []
    for batch, e in zip(batches, eps):
        state, (m, upd) = fn(state, c, dp.shard_batch(batch), jnp.asarray(e))
        want.append({k: float(v) for k, v in m.items()})
    want_updates = {k: np.asarray(v) for k, v in _flatten(jax.device_get(upd)).items()}
    _hold(recs[0]["metrics"], want, updates, want_updates, "2 ranks vs JAX DataParallel(2)")


def test_two_rank_fit_matches_the_single_process_fit(tmp_path):
    """Trainer.fit over 2 ranks (2 epochs of 3 steps, per-epoch eval through
    all_gather_rows, lead-only checkpoints) against the single-process fit
    of the same global batch: val losses and final parameters within 1e-4
    relative (JAX's 8-device fit test's tolerance)."""
    from cape_tpu_torch.train.loop import Trainer

    out = str(tmp_path / "run")
    outs = _spawn(lambda rank, port: [__file__, "worker", "fit", out, str(rank), str(N_RANKS),
                                      str(port)])
    recs = _rank_records(outs)
    assert recs[0]["metrics"] == recs[1]["metrics"]
    assert sorted(os.listdir(out + ".workdir")) == ["dp_fit"]
    cfg, ctx, data = _setup("dp_fit", num_epochs=2)
    single = Trainer(cfg.replace(data_parallel=0), _model(cfg, ctx), ctx, data,
                     workdir=str(tmp_path / "single"))
    val, _ = single.fit()
    np.testing.assert_allclose([m["val_recon"] for m in recs[0]["metrics"]], val,
                               rtol=1e-4, atol=1e-5)
    with np.load(out + ".0.npz") as f, np.load(out + ".1.npz") as f1:
        assert int(f["step"]) == single.state.step == 6
        for k, v in single.model.state_dict().items():
            np.testing.assert_array_equal(f[f"param/{k}"], f1[f"param/{k}"], err_msg=k)
            np.testing.assert_allclose(f[f"param/{k}"], v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_two_rank_fit_from_a_seed_is_jax_fit(tmp_path):
    """Trainer.fit over 2 ranks from JAX's PRNGKey(cfg.seed) parameters (2
    epochs of 3 steps, dispatch chunks of 2): step s gives each rank its
    rows of the global draw normal(fold_in(PRNGKey(seed), s), (16, nz)),
    bit-equal to core.prng's and within 1e-6 of jax.random.normal (JAX's
    partitionable threefry gives the global array whatever the sharding);
    the val recons and the final parameters are JAX's Trainer.fit's from the
    same seed, within 1e-4 * max|val| and 1e-3 of each leaf's max|final -
    init| plus one float32 ulp of the leaf per step."""
    import jax

    from cape_tpu.core.config import CAPEConfig as JaxConfig
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.meshops.toy import icosphere
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu.ops.sparse import build_graph_context
    from cape_tpu.train.loop import Trainer as JaxTrainer
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.core.bridge import _flatten

    out = str(tmp_path / "run")
    outs = _spawn(lambda rank, port: [__file__, "worker", "seeded", out, str(rank),
                                      str(N_RANKS), str(port)])
    recs = _rank_records(outs)
    assert recs[0]["metrics"] == recs[1]["metrics"]
    cfg, ctx, data = _setup("dp_seeded", **SEEDED)
    ranks = [np.load(f"{out}.{r}.npz") for r in range(N_RANKS)]
    n_steps = int(ranks[0]["step"])
    assert n_steps == 6
    for s in range(n_steps):
        key = prng.fold_in(prng.PRNGKey(cfg.seed), s)
        want = prng.normal(key, (cfg.batch_size, cfg.nz))
        for f in ranks:
            lo, hi = f["rows"]
            np.testing.assert_array_equal(f["eps"][s], want[lo:hi], err_msg=f"step {s}")
        jwant = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(cfg.seed), s),
                                             (cfg.batch_size, cfg.nz)))
        np.testing.assert_allclose(np.concatenate([f["eps"][s] for f in ranks]), jwant,
                                   rtol=0, atol=1e-6)

    verts, faces = icosphere(3)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "name", "nf", "nz", "nz_cond", "nz_cond2", "use_res_block", "use_res_block_dec",
        "affine", "reduce_dim", "batch_size", "num_epochs", "steps_per_dispatch",
        "tensorboard", "seed")}, data_parallel=1)
    jctx = build_graph_context(build_pyramid(verts, faces, jcfg.ds_factors),
                               build_pyramid(verts, faces, [2, 2, 2, 2]),
                               vertices_per_edge(faces, len(verts)), verts,
                               padded=jcfg.padded_layout)
    jtrainer = JaxTrainer(jcfg, JaxCAPE(jcfg), jctx, data, workdir=str(tmp_path / "jax"))
    jval, _ = jtrainer.fit()
    val = [m["val_recon"] for m in recs[0]["metrics"]]
    np.testing.assert_allclose(val, jval, rtol=0, atol=1e-4 * np.abs(jval).max())
    init = _flatten(JaxCAPE(jcfg).init_params(jax.random.PRNGKey(cfg.seed), jctx))
    final = _flatten(jax.device_get(jtrainer.state.params))
    for k, w in final.items():
        w, scale = np.asarray(w), np.abs(np.asarray(w) - np.asarray(init[k])).max()
        atol = 1e-3 * scale + n_steps * np.spacing(np.abs(w).max())
        for f in ranks:
            np.testing.assert_allclose(f[f"param/{k}"], w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("mode", ["step", "trainer"])
def test_multihost_selftest_two_processes(mode):
    """`python -m cape_tpu_torch.parallel.multihost RANK 2 PORT mode`: both
    ranks print the same record; the trainer's resume (the non-lead rank on
    an empty workdir, the lead's state broadcast) ends at step 9, as JAX's."""
    outs = _spawn(lambda rank, port: ["-m", "cape_tpu_torch.parallel.multihost", str(rank),
                                      str(N_RANKS), str(port), mode])
    recs = {}
    for out in outs:
        rec = json.loads(re.search(r"SELFTEST (\{.*\})", out).group(1))
        recs[rec.pop("rank")] = rec
    assert set(recs) == {0, 1} and recs[0] == recs[1], recs
    if mode == "trainer":
        assert len(recs[0]["val_recon"]) == 2
        assert recs[0]["resume_end_step"] == 9, recs[0]
    else:
        assert all(np.isfinite(v) for v in recs[0]["metrics"].values())


def test_trainer_without_a_group_refuses_data_parallel(tmp_path):
    """Without a process group a Trainer drives one device: data_parallel=2
    asks for more and raises the over-request ValueError; a batch the group
    cannot split raises JAX's ValueError."""
    from cape_tpu_torch.parallel.mesh import DataParallel
    from cape_tpu_torch.train.loop import Trainer

    cfg, ctx, data = _setup()
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 1"):
        Trainer(cfg, _model(cfg, ctx), ctx, data, workdir=str(tmp_path))
    t = Trainer(cfg.replace(data_parallel=1), _model(cfg, ctx), ctx, data,
                workdir=str(tmp_path))
    assert t.dp.num_devices == 1 and t.lead and t.rows == (0, cfg.batch_size)
    with pytest.raises(ValueError, match="the rank's device"):
        Trainer(cfg.replace(data_parallel=0), _model(cfg, ctx), ctx, data,
                workdir=str(tmp_path), dp=DataParallel(2, devices=["cpu", "cpu"]))


def test_engine_over_two_devices_matches_one():
    """InferenceEngine(dp=DataParallel(devices=[cpu, cpu])): 2 rows a device,
    padded calls of 4 split in device order, every chunk launched before any
    is read; encode, decode and the sampled autoencode of 5 rows equal the
    single-device engine's at batch 4 within 1e-5 * max|ref|, with one device
    call per device and padded call."""
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.parallel.mesh import DataParallel

    cfg, ctx, data = _setup()
    model = _model(cfg, ctx)
    one = InferenceEngine(model, ctx, batch_size=4, device="cpu")
    two = InferenceEngine(_model(cfg, ctx), ctx, batch_size=2,
                          dp=DataParallel(devices=["cpu", "cpu"]))
    assert two.batch_size == 4 and two.devices == [torch.device("cpu")] * 2
    disp, pose, clo = (a[:5] for a in data.split("val"))
    for name, fn in (("encode", lambda e: e.encode(disp, pose, clo)),
                     ("autoencode", lambda e: e.autoencode(disp, pose, clo, rng=3, sample=True))):
        got, want = fn(two), fn(one)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
    assert two.calls == {k: 2 * v for k, v in one.calls.items()}
    assert one.calls["decode"] == 2 and one.calls["encode"] == 4


def _packed_dataset(root, cfg, n_train=108, n_test=4):
    """A packed dataset of synthetic frames on the full template at
    <root>/data/datasets/<cfg.dataset> (BodyData.from_packed's layout)."""
    from cape_tpu_torch.data.synthetic import synthetic_bodydata

    syn = synthetic_bodydata(n_train=n_train, n_test=n_test, num_verts=6890, seed=0,
                             pose_type=cfg.pose_type, n_val=4)
    for phase, disp, pose, clo in (
        ("train", np.concatenate([syn.disp_train, syn.disp_val]),
         np.concatenate([syn.pose_train_full, syn.pose_val_full]),
         np.concatenate([syn.clo_train, syn.clo_val])),
        ("test", syn.disp_test, syn.pose_test_full, syn.clo_test),
    ):
        d = os.path.join(root, "data", "datasets", cfg.dataset, phase)
        os.makedirs(d)
        np.save(os.path.join(d, f"{phase}_disp.npy"), disp)
        np.save(os.path.join(d, f"{phase}_{cfg.pose_type}.npy"), pose)
        np.save(os.path.join(d, f"{phase}_clo_label.npy"), clo)


@pytest.mark.parametrize("launch", ["data_parallel", "torchrun"])
def test_main_data_parallel_two_cpu_ranks(tmp_path, launch):
    """`python -m cape_tpu_torch.apps.main --mode train --device cpu
    --data_parallel 2`, and the same under torchrun with 2 processes and no
    --data_parallel, on the nz18 release preset cut to nf=8 (a packed
    dataset of 108 synthetic frames, 100 of them validation, so 2 steps of
    global batch 4 an epoch): 2 Gloo ranks train 1 epoch, and the lead
    alone writes metrics.jsonl, the checkpoint and the demo outputs. The
    server's `--data_parallel 2 --device cpu` asks for more devices than
    the CPU host has and raises the over-request ValueError before it
    builds anything."""
    from cape_tpu_torch.apps import server
    from cape_tpu_torch.core.config import load_config

    preset = os.path.join(ROOT, "configs", "CAPE-affineconv_nz18_pose24_clotype8_male.yaml")
    _packed_dataset(str(tmp_path), load_config(preset))
    runs = tmp_path / "runs"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    args = ["--config", preset, "--name", "dp2", "--mode", "train", "--device", "cpu",
            "--batch_size", "4", "--num_epochs", "1", "--nf", "8", "--reduce_dim", "8",
            "--demo_n_sample", "1", "--workdir", str(runs)]
    if launch == "torchrun":
        cmd = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
               "-m", "cape_tpu_torch.apps.main", *args]
        env["OMP_NUM_THREADS"] = "1"
    else:
        cmd = ["-m", "cape_tpu_torch.apps.main", *args, "--data_parallel", "2"]
    proc = subprocess.run([sys.executable, *cmd], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=2 * RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("loading packed dataset") == 2   # both ranks load it
    records = [json.loads(line) for line in (runs / "dp2" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1] and np.isfinite(records[0]["val_recon"])
    assert os.listdir(runs / "dp2" / "checkpoints") == ["ckpt_0000000002.npz"]
    assert proc.stdout.count("training done") == 2 and proc.stdout.count("step=1 ") == 1
    assert len(os.listdir(runs / "dp2" / "sample_vary_pose")) == 6
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 1"):
        server.main(["--config", preset, "--name", "x", "--data_parallel", "2",
                     "--device", "cpu", "--fresh-init"])


if __name__ == "__main__":   # python tests/test_torch_parallel.py worker MODE OUT RANK N PORT
    _worker(sys.argv[2], sys.argv[3], *map(int, sys.argv[4:7]))
