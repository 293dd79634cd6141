"""Tensor parallelism in the PyTorch port (`parallel/mesh2d.py`), on the CPU:
the leaf rule against JAX's `MeshParallel._leaf_spec`, the 2-D mesh, the
four collectives, two train steps on (1, 2), (2, 2) and (1, 4) meshes
against JAX's `MeshParallel` step on the virtual CPU devices and against
the port's single-process step, each rank's shards, a 2x2 Trainer.fit with
its resume and checkpoint, and `Trainer.predict` against JAX's.

The model is the multihost selftest's (`parallel.multihost._tiny`: the
icosphere(3) model at nf=4, global batch 16). Its leaves at tp = 2 are
column-parallel but for a replicated bias, the condition net's first dense
kernel, the discriminator's pred conv and the decoder's output conv, which
are row-parallel: the output conv is folded, and its 2 | 8 | 4 input rows of
x | y | y2 split 7 | 7, so rank 0 holds x and 5 rows of y and rank 1 the
rest of y and y2; its vertex bias splits on the vertex axis. At tp = 4 the
folded decoder block layer6 is row-parallel (rank 0 holds x's 4 rows, the
others condition rows only), and layer7, the output conv and the
condition net's first layer are replicated. The ranks are Gloo
processes running this file as a script (`python tests/test_torch_mesh2d.py
worker MODE OUT RANK N PORT`), one thread each, each with a timeout, killed
on it; at most 4 ranks a spawn.
"""

import contextlib
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
from test_torch_parallel import STEPS, _hold, _inputs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300   # seconds a spawned rank may take
# the routing gate lowered for the tiny model (16 rows a rank at dp = 1):
# every K=2 conv with 2 or more input channels on a rank takes the v3 route
GATE = {"VM_MIN_BATCH": 16, "VM_MIN_COLS": 32}
FOUR_MESHES = [(2, 2), (1, 4)]   # the 4-rank spawn's step meshes
# the model variants the steps run beside the base model, by mesh
# (the CMR one is test_torch_families.py's CMR train-step model, 4 layers at
# nf=32 (its group norms need 32 | channels), with residual encoder blocks)
VARIANTS = {"cmr_remat": dict(num_conv_layers=4, nf=32, nz_cond=24, nz_cond2=8,
                              use_res_block=True, affine=False, reduce_dim=4, remat=True),
            "fused": dict(fuse_decoder=True)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(n: int, argv_of_rank, timeout=RANK_TIMEOUT) -> list[str]:
    """Run n processes (argv_of_rank(rank, port) each, from the repo root),
    wait for all with a timeout, kill any left; every rank must exit 0.
    Returns their standard outputs."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv_of_rank(rank, port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(n)]
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


def _setup(name="tp_test", **overrides):
    """The tiny model's config (global batch 16), context (with the composed
    L~@U operators when the decoder is fused) and data."""
    from cape_tpu_torch.meshops.pyramid import build_pyramid
    from cape_tpu_torch.meshops.topology import vertices_per_edge
    from cape_tpu_torch.meshops.toy import icosphere
    from cape_tpu_torch.ops.sparse import build_graph_context
    from cape_tpu_torch.parallel.multihost import _tiny

    cfg, ctx, data = _tiny(name, 2)
    if overrides:
        cfg = cfg.replace(**overrides)
        verts, faces = icosphere(3)
        ctx = build_graph_context(build_pyramid(verts, faces, cfg.ds_factors),
                                  build_pyramid(verts, faces, [2, 2, 2, 2]),
                                  vertices_per_edge(faces, len(verts)), verts,
                                  padded=cfg.padded_layout, build_fused=cfg.fuse_decoder)
    return cfg, ctx, data


def _model(cfg, ctx):
    """The tiny model's parameters in the test form (`core.params`:
    torch.Generator seed 0), which these tests hold the ranks to the single
    process and to JAX on. (At JAX's PRNGKey(0) parameters the residual-CMR
    variant's step 2 is ill-conditioned: moving every parameter by one ulp
    moves a gradient leaf by up to 8% in one process, beyond the 1e-3 step
    tolerance.)"""
    return CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)


def _whole(model, tensors: dict) -> dict:
    """{name: tensor shaped like the parameter `name`'s shard} gathered
    whole over the model group, as numpy."""
    from cape_tpu_torch.parallel.mesh2d import shard_of

    named = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for k, t in tensors.items():
            s = shard_of(named[k])
            out[k] = (t if s is None else s.gather(t, s.axis)).float().numpy()
    return out


@contextlib.contextmanager
def _gathered(model):
    """Record the parameters (by name; a detached one by its storage) that
    `mesh2d.full` gathers whole while the block runs."""
    from cape_tpu_torch.core import params
    from cape_tpu_torch.models import blocks
    from cape_tpu_torch.parallel import mesh2d

    names = {p.data_ptr(): n for n, p in model.named_parameters()}
    seen, full = set(), mesh2d.full

    def recorded(t):
        if mesh2d.shard_of(t) is not None:
            seen.add(names[t.data_ptr()])
        return full(t)

    mods = (params, blocks, mesh2d)
    for m in mods:
        m.full = recorded
    try:
        yield seen
    finally:
        for m in mods:
            m.full = full


def _mesh_steps(mp, cfg, ctx, batches, eps) -> dict:
    """STEPS train steps of the seed-0 model on MeshParallel `mp`, each rank
    its data group's rows: the reduced metrics per step, the last step's
    updates gathered whole, every parameter's and optimizer buffer's local
    shape, and the gradients of the replicated leaves on the first batch."""
    from cape_tpu_torch.parallel.mesh2d import shard_of
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, gan_losses, train_step

    model = mp.replicate(_model(cfg, ctx))
    state = mp.shard_state(TrainState(model, Optimizer(cfg, 10)))
    lo, hi = mp.local_rows(cfg.batch_size)
    rows = lambda b: {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])) for k, v in b.items()}
    metrics = []
    with _gathered(model) as gathered:
        for batch, e in zip(batches, eps):
            m, updates = train_step(state, ctx, rows(batch), torch.from_numpy(e[lo:hi]),
                                    reduce=mp.all_reduce_mean)
            metrics.append({k: float(v) for k, v in mp.all_reduce_mean(m).items()})
    named = dict(model.named_parameters())
    total, _ = gan_losses(model, cfg, ctx, rows(batches[0]), torch.from_numpy(eps[0][lo:hi]))
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    return {
        "metrics": metrics,
        "gathered": sorted(gathered),
        "updates": _whole(model, updates),
        "shapes": {k: list(p.shape) for k, p in named.items()},
        "buffers": {k: {s: list(b.shape) for s, b in v.items()}
                    for k, v in state.tx.buffers.items()},
        "replicated_grads": {k: g.numpy() for k, g in grads.items()
                             if shard_of(named[k]) is None},
    }


def _routes(mp, cfg, ctx, batch, e) -> list:
    """The (B, C, F) of every conv one train step of the tiny model sends to
    the v3 route on this rank of `mp`, under the lowered GATE."""
    from cape_tpu_torch.ops import cheb
    from cape_tpu_torch.ops.kernels import cheb_kernel
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    seen, v3, gate = [], cheb_kernel.cheb2_banded_v3, {k: getattr(cheb, k) for k in GATE}

    def logged(x, band_op, weight):
        seen.append((x.shape[0], x.shape[2], weight.shape[2]))
        return v3(x, band_op, weight)

    model = mp.replicate(_model(cfg, ctx))
    state = mp.shard_state(TrainState(model, Optimizer(cfg, 10)))
    lo, hi = mp.local_rows(cfg.batch_size)
    try:
        cheb_kernel.cheb2_banded_v3 = logged
        for k, v in GATE.items():
            setattr(cheb, k, v)
        train_step(state, ctx, {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
                                for k, v in batch.items()}, torch.from_numpy(e[lo:hi]),
                   reduce=mp.all_reduce_mean)
    finally:
        cheb_kernel.cheb2_banded_v3 = v3
        for k, v in gate.items():
            setattr(cheb, k, v)
    return sorted(seen)


def _clipped_updates(mp, cfg, ctx) -> float:
    """One optimizer update of seeded gradients scaled so that both
    players' clips act (global norms >> 5), from this rank's shards of
    them, gathered whole, against the update of the whole gradients in one
    process: the worst error relative to a leaf's max|update|."""
    from cape_tpu_torch.parallel.mesh2d import shard_of
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState

    model = mp.replicate(_model(cfg, ctx))
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    state = mp.shard_state(TrainState(model, Optimizer(cfg, 10)))
    g = torch.Generator().manual_seed(4)
    grads = {k: 100.0 * torch.randn(shape, generator=g) for k, shape in whole.items()}
    named = dict(model.named_parameters())
    local = {k: v if shard_of(named[k]) is None else shard_of(named[k]).local(v)
             for k, v in grads.items()}
    got = _whole(model, state.tx.update(local))
    want = Optimizer(cfg, 10).update(grads)
    return max(float(np.abs(got[k] - w.numpy()).max() / w.abs().max()) for k, w in want.items())


def _collectives(rank: int) -> dict:
    """The four collectives on 2 ranks in f64, forward and backward, against
    their definitions: {check: max abs error}."""
    from cape_tpu_torch.parallel.mesh2d import Shard

    import torch.distributed as dist

    s = Shard(axis=2, size=6, index=rank, tp=2, group=dist.group.WORLD)
    g = torch.Generator().manual_seed(0)
    both = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    x = both(2, 5, 4)                        # the same on both ranks
    w = [both(2, 5, 4), both(2, 5, 4)]       # a rank's own loss weights
    errs = {}

    xc = x.clone().requires_grad_()
    (y,) = s.copy(xc)
    (y * w[rank]).sum().backward()
    errs["copy forward"] = float((y.detach() - x).abs().max())
    errs["copy backward"] = float((xc.grad - (w[0] + w[1])).abs().max())

    parts = [both(2, 5, 3), both(2, 5, 3)]   # a rank's own partial
    xr = parts[rank].clone().requires_grad_()
    y = s.reduce(xr)
    (y * w[0][..., :3]).sum().backward()
    errs["reduce forward"] = float((y.detach() - parts[0] - parts[1]).abs().max())
    errs["reduce backward"] = float((xr.grad - w[0][..., :3]).abs().max())

    xg = parts[rank].clone().requires_grad_()
    y = s.gather(xg)
    up = both(2, 5, 6)
    (y * up).sum().backward()
    errs["gather forward"] = float((y.detach() - torch.cat(parts, -1)).abs().max())
    errs["gather backward"] = float((xg.grad - up[..., 3 * rank: 3 * rank + 3]).abs().max())

    # scatter of [x (4) | c (2)] over 6 rows: rank 0 takes x[..., :3], no
    # row of c; rank 1 x[..., 3:] and all of c. Rank r's loss weights lw[r]
    # (each rank draws both ranks')
    c = both(2, 5, 2)
    lw = [[torch.randn(2, 5, n, generator=torch.Generator().manual_seed(10 + r + 2 * i),
                       dtype=torch.float64) for i, n in enumerate(widths)]
          for r, widths in enumerate([(3, 0), (1, 2)])]
    xs, cs = x.clone().requires_grad_(), c.clone().requires_grad_()
    ys = s.scatter([xs, cs])
    sum((t * v).sum() for t, v in zip(ys, lw[rank])).backward()
    want = ([x[..., :3], c[..., :0]], [x[..., 3:], c])[rank]
    errs["scatter forward"] = max(float((a.detach() - b).abs().max()) if a.numel() else 0.0
                                  for a, b in zip(ys, want))
    # the gradient: every rank's loss weights, at its rows
    errs["scatter backward"] = max(
        float((xs.grad - torch.cat([lw[0][0], lw[1][0]], -1)).abs().max()),
        float((cs.grad - lw[1][1]).abs().max()))
    return errs


# ------------------------------------------------------------------- ranks
def _worker(mode: str, out: str, rank: int, n: int, port: int) -> None:
    """One rank of a spawn of n: `two` (the collectives, then STEPS steps of
    the base model and of the CMR variant with remat on (1, 2)) or `four`
    (STEPS steps on FOUR_MESHES and of the fused decoder on (1, 4), then a
    2-epoch Trainer.fit on (2, 2) and its 1-epoch resume). Writes
    <out>.<rank>.npz and prints one RANK record."""
    import torch.distributed as dist

    from cape_tpu_torch.parallel import multihost
    from cape_tpu_torch.parallel.mesh2d import MeshParallel
    from cape_tpu_torch.train import checkpoint as ckpt
    from cape_tpu_torch.train.loop import Trainer

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", n, rank, backend="gloo")
    try:
        rec, arrays = {"rank": rank}, {}
        with np.load(out + ".inputs.npz") as f:
            eps = f["eps"]
            batches = [{k.split("/")[1]: f[k] for k in f.files if k.startswith(f"{i}/")}
                       for i in range(STEPS)]
        runs = ([("base", 1, 2), ("cmr_remat", 1, 2)] if mode == "two"
                else [("base", *m) for m in FOUR_MESHES] + [("fused", 1, 4)])
        if mode == "two":
            rec["collectives"] = _collectives(rank)
            cfg, ctx, _ = _setup()
            rec["clip"] = _clipped_updates(MeshParallel(1, 2, device=torch.device("cpu")),
                                           cfg, ctx)
        for variant, dp, tp in runs:
            mp = MeshParallel(dp, tp, device=torch.device("cpu"))
            cfg, ctx, _ = _setup(**VARIANTS.get(variant, {}))
            got = _mesh_steps(mp, cfg, ctx, batches, eps)
            tag = f"{variant}/{dp}x{tp}"
            if variant == "base" and dp == 1:
                rec[f"routes/{tp}"] = _routes(mp, cfg, ctx, batches[0], eps[0])
            if (dp, tp) == (2, 2):
                rec["pad"] = [mp.pad_batch_size(b) for b in (16, 17, 1)]
            rec[tag] = {"metrics": got["metrics"], "shapes": got["shapes"],
                        "gathered": got["gathered"],
                        "buffers": got["buffers"], "coords": [mp.data_index, mp.model_index],
                        "rows": list(mp.local_rows(cfg.batch_size))}
            arrays.update({f"{tag}/update/{k}": v for k, v in got["updates"].items()})
            arrays.update({f"{tag}/grad/{k}": v for k, v in got["replicated_grads"].items()})
        if mode == "four":
            mp = MeshParallel(2, 2, device=torch.device("cpu"))
            cfg, ctx, data = _setup("tp_fit", num_epochs=2)
            trainer = Trainer(cfg, _model(cfg, ctx), ctx, data, workdir=out + ".workdir", dp=mp)
            val, _ = trainer.fit()
            rec["fit"] = {"val_recon": [float(v) for v in val], "step": trainer.state.step,
                          "shapes": {k: list(p.shape)
                                     for k, p in trainer.model.named_parameters()}}
            arrays.update({f"fit/param/{k}": v.numpy() for k, v in
                           mp.full_state(trainer.state).model.state_dict().items()})
            arrays["fit/predict"] = trainer.predict(*data.split("test"))
            cfg2 = cfg.replace(restart=False, num_epochs=1)
            resumed = Trainer(cfg2, _model(cfg2, ctx), ctx, data, workdir=out + ".workdir",
                              dp=mp)
            resumed.fit()
            rec["fit"]["resume_end_step"] = resumed.state.step
            arrays.update({f"resumed/{k}": v for k, v in
                           ckpt.flatten_state(mp.full_state(resumed.state)).items()})
        np.savez(f"{out}.{rank}.npz", **arrays)
        print("RANK " + json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()


def _records(outs) -> list[dict]:
    recs = [json.loads(re.search(r"RANK (\{.*\})", o).group(1)) for o in outs]
    assert [r["rank"] for r in recs] == list(range(len(outs)))
    return recs


def _run(tmp_path_factory, mode: str, n: int):
    from cape_tpu_torch.parallel.multihost import _tiny

    cfg, ctx, data = _tiny("tp_test", 2)
    batches, eps = _inputs(cfg, ctx, data)
    out = str(tmp_path_factory.mktemp(f"tp_{mode}") / "run")
    np.savez(out + ".inputs.npz", eps=eps,
             **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    recs = _records(_spawn(n, lambda rank, port: [__file__, "worker", mode, out, str(rank),
                                                  str(n), str(port)]))
    arrays = [dict(np.load(f"{out}.{r}.npz")) for r in range(n)]
    return {"batches": batches, "eps": eps, "recs": recs, "arrays": arrays, "out": out}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run(tmp_path_factory, "two", 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run(tmp_path_factory, "four", 4)


def _single_steps(variant, batches, eps):
    from test_torch_parallel import _port_steps

    cfg, ctx, _ = _setup(**VARIANTS.get(variant, {}))
    return _port_steps(cfg.replace(data_parallel=0), ctx, batches, eps)


def _jax_mesh_steps(dp, tp, batches, eps):
    """JAX's MeshParallel(dp, tp) train step (one jit over dp*tp virtual CPU
    devices, every state leaf placed by _leaf_spec, GSPMD's collectives)
    from the seed-0 parameters, on the same batches and eps: (metrics per
    step, the last step's updates)."""
    import jax
    import jax.numpy as jnp

    from cape_tpu.core.config import CAPEConfig as JaxConfig
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.meshops.toy import icosphere
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu.ops.sparse import build_graph_context
    from cape_tpu.parallel.mesh2d import MeshParallel as JaxMeshParallel
    from cape_tpu.train.optim import TrainState, build_optimizer, create_train_state
    from cape_tpu.train.step import _gan_losses
    from cape_tpu_torch.core.bridge import _flatten, to_jax_params

    cfg, ctx, _ = _setup()

    class EpsCAPE(JaxCAPE):
        def sample_z(self, rng, z_mean, z_logvar):
            return z_mean + jnp.exp(0.5 * jnp.clip(z_logvar, -30.0, 30.0)) * rng

    verts, faces = icosphere(3)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "name", "nf", "nz", "nz_cond", "nz_cond2", "use_res_block", "use_res_block_dec",
        "affine", "reduce_dim", "batch_size")})
    jctx = build_graph_context(build_pyramid(verts, faces, jcfg.ds_factors),
                               build_pyramid(verts, faces, [2, 2, 2, 2]),
                               vertices_per_edge(faces, len(verts)), verts,
                               padded=jcfg.padded_layout)
    tx, _, _ = build_optimizer(jcfg, 10)
    jmodel = EpsCAPE(jcfg)

    def step_fn(state, c, batch, e):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: _gan_losses(jmodel, jcfg, p, c, batch, e), has_aux=True)(state.params)
        upd, opt_state = tx.update(grads, state.opt_state, state.params)
        new = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype), state.params, upd)
        return TrainState(step=state.step + 1, params=new, opt_state=opt_state), (metrics, upd)

    mp = JaxMeshParallel(dp, tp)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(_model(cfg, ctx)))
    state = create_train_state(params, tx)
    fn = mp.compile_train_step(step_fn, state)
    state, c = mp.shard_state(state), mp.replicate(jctx)
    want = []
    for batch, e in zip(batches, eps):
        state, (m, upd) = fn(state, c, mp.shard_batch(batch), jnp.asarray(e))
        want.append({k: float(v) for k, v in m.items()})
    return want, {k: np.asarray(v) for k, v in _flatten(jax.device_get(upd)).items()}


def _updates(run, tag: str, rank: int = 0) -> dict:
    pre = f"{tag}/update/"
    return {k[len(pre):]: v for k, v in run["arrays"][rank].items() if k.startswith(pre)}


def _expected_shape(shape, tp: int, index: int) -> list:
    from cape_tpu_torch.parallel.mesh2d import MODEL_AXIS, leaf_spec

    spec = leaf_spec(shape, tp)
    out = list(shape)
    if MODEL_AXIS in spec:
        out[spec.index(MODEL_AXIS)] //= tp
    return out


# -------------------------------------------------------------------- tests
def _flagship_shapes():
    """{leaf: shape} of the flagship, both CMR release presets and
    default_config.yaml (JAX's eval_shape of init_params on the full
    template's context)."""
    import jax

    from cape_tpu.apps.main import build_context
    from cape_tpu.core.config import load_config
    from cape_tpu.models.cape import CAPE as JaxCAPE

    presets = ["CAPE-affineconv_nz64_pose32_clotype32_male.yaml",
               "CAPE_nz18_pose24_clotype8_male.yaml", "CAPE_nz18_pose24_clotype8_female.yaml",
               "default_config.yaml"]
    shapes, ctx = {}, None
    for name in presets:
        cfg = load_config(os.path.join(ROOT, "configs", name))
        ctx = build_context(cfg) if ctx is None else ctx   # one pyramid serves all four
        tree = jax.eval_shape(JaxCAPE(cfg).init_params, jax.random.PRNGKey(0), ctx)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            shapes[f"{name}:{jax.tree_util.keystr(path)}"] = tuple(leaf.shape)
    return shapes


def test_leaf_spec_equals_jax_on_every_preset_leaf():
    """leaf_spec (MeshParallel._leaf_spec) gives JAX's PartitionSpec, as a
    tuple, on every parameter leaf of the flagship, both CMR release
    presets and default_config.yaml at tp = 2, 3, 4 and 8, and on JAX's own
    cases (tests/test_parallel.py)."""
    from cape_tpu.parallel.mesh2d import MeshParallel as JaxMeshParallel
    from cape_tpu_torch.parallel.mesh2d import MODEL_AXIS, leaf_spec

    shapes = _flagship_shapes()
    assert len(shapes) > 150
    jax_cases = [(2, 3, 8), (2, 8, 3), (2, 3, 3), (), (6, 4), (4, 3), (8,)]
    for tp in (2, 3, 4, 8):
        jmp = JaxMeshParallel(1, tp)
        for name, shape in [*shapes.items(), *((str(s), s) for s in jax_cases)]:
            assert leaf_spec(shape, tp) == tuple(jmp._leaf_spec(np.zeros(shape))), (tp, name)
    want = {(2, 3, 8): (None, None, MODEL_AXIS), (2, 8, 3): (None, MODEL_AXIS, None),
            (2, 3, 3): (), (): (), (6, 4): (None, MODEL_AXIS), (4, 3): (MODEL_AXIS, None),
            (8,): (MODEL_AXIS,)}
    assert {s: leaf_spec(s, 4) for s in jax_cases} == want
    # the flagship's exceptions at tp = 2 (every other leaf is column-parallel)
    flag = "CAPE-affineconv_nz64_pose32_clotype32_male.yaml:"
    spec = lambda leaf, tp: leaf_spec(shapes[flag + leaf], tp)
    assert spec("['cond_pose']['fc1']['kernel']", 2) == (MODEL_AXIS, None)
    assert spec("['cond_pose']['fc1']['kernel']", 4) == ()
    assert spec("['generator']['decoder']['out']['w']", 2) == (None, MODEL_AXIS, None)
    assert spec("['generator']['decoder']['out']['b']", 2) == (MODEL_AXIS, None)
    assert spec("['discriminator']['pred']['w']", 4) == (None, MODEL_AXIS, None)


def test_make_mesh_2d_shapes_and_the_over_request():
    """make_mesh_2d lays dp*tp devices (or ranks) out row-major, JAX's
    reshape(dp, tp), and an over-request raises JAX's ValueError;
    MeshParallel refuses a group of another size and a process without a
    group."""
    from cape_tpu_torch.parallel.mesh2d import MeshParallel, make_mesh_2d

    assert make_mesh_2d(4, 2, range(8)) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert make_mesh_2d(1, 3, range(5)) == [[0, 1, 2]]
    cpu = torch.device("cpu")
    assert make_mesh_2d(2, 1, [cpu] * 2) == [[cpu], [cpu]]
    with pytest.raises(ValueError, match="need 8 devices for a 4x2 mesh, have 6"):
        make_mesh_2d(4, 2, range(6))
    # by default the host's devices: this host's one CPU device
    if not torch.cuda.is_available():
        assert make_mesh_2d(1, 1) == [[cpu]]
        with pytest.raises(ValueError, match="need 2 devices for a 1x2 mesh, have 1"):
            make_mesh_2d(1, 2)
    with pytest.raises(RuntimeError, match="needs a process group"):
        MeshParallel(1, 2)


def test_local_rows_pad_batch_size_and_coordinates(four):
    """On the 4-rank meshes: group rank r sits at (r // tp, r % tp); the tp
    ranks of a model group feed the same rows (by data index), and the
    batch pads over dp only (JAX's pad_batch_size cases)."""
    for dp, tp in FOUR_MESHES:
        for r, rec in enumerate(four["recs"]):
            got = rec[f"base/{dp}x{tp}"]
            assert got["coords"] == [r // tp, r % tp]
            per = 16 // dp
            assert got["rows"] == [per * (r // tp), per * (r // tp + 1)]
    assert [rec["pad"] for rec in four["recs"]] == [[16, 18, 2]] * 4


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
def test_mesh_step_matches_jax_mesh_parallel_and_the_single_process(two, four, mesh):
    """STEPS steps of the tiny model on the (dp, tp) mesh against JAX's
    MeshParallel(dp, tp) step from the same parameters, batches and eps,
    and against the port's single-process step: metrics within 1e-4
    relative, the step-2 updates within 1e-3 of each leaf's max|update|
    (_hold); every rank reports the same metrics and, gathered, the same
    updates."""
    dp, tp = map(int, mesh.split("x"))
    run = two if tp * dp == 2 else four
    tag = f"base/{mesh}"
    metrics = [rec[tag]["metrics"] for rec in run["recs"]]
    assert all(m == metrics[0] for m in metrics)
    got = _updates(run, tag)
    for r in range(1, len(run["recs"])):
        for k, v in _updates(run, tag, r).items():
            np.testing.assert_allclose(v, got[k], rtol=0, atol=1e-6 * np.abs(got[k]).max(),
                                       err_msg=f"rank {r} {k}")
    want, want_updates = _single_steps("base", run["batches"], run["eps"])
    _hold(metrics[0], want, got, want_updates, f"{mesh} vs the single process")
    want, want_updates = _jax_mesh_steps(dp, tp, run["batches"], run["eps"])
    _hold(metrics[0], want, got, want_updates, f"{mesh} vs JAX MeshParallel({dp}, {tp})")


@pytest.mark.parametrize("case", ["cmr_remat/1x2", "fused/1x4"])
def test_mesh_step_of_other_families_matches_the_single_process(two, four, case):
    """The CMR group-norm decoder with residual encoder blocks and remat on
    (1, 2) (the group norms' sharded gamma and beta gathered, the
    collectives recomputed in the backward), and the fused decoder on
    (1, 4) (its last two blocks row-parallel: both branches reduced before
    the relu), against the single-process step (_hold)."""
    run = two if case.endswith("1x2") else four
    variant = case.split("/")[0]
    metrics = [rec[case]["metrics"] for rec in run["recs"]]
    assert all(m == metrics[0] for m in metrics)
    want, want_updates = _single_steps(variant, run["batches"], run["eps"])
    _hold(metrics[0], want, _updates(run, case), want_updates, f"{case} vs the single process")


@pytest.mark.parametrize("case", ["base/1x2", "cmr_remat/1x2", "base/2x2", "base/1x4",
                                  "fused/1x4"])
def test_each_rank_holds_its_shards_and_equal_replicated_gradients(two, four, case):
    """Every rank's parameters and optimizer buffers have the shapes of its
    shards (JAX's rule; the momentum buffer too), the tiny model's
    row-parallel and replicated leaves are among them, no conv weight or
    dense kernel is gathered whole for its product (only biases, norms'
    gammas and betas and the vertex bias are), and a replicated leaf's
    gradient is the same on every rank of a model group."""
    run = two if case.endswith("1x2") else four
    variant, mesh = case.split("/")
    dp, tp = map(int, mesh.split("x"))
    cfg, ctx, _ = _setup(**VARIANTS.get(variant, {}))
    whole = {k: tuple(p.shape) for k, p in _model(cfg, ctx).named_parameters()}
    kinds = set()
    for r, rec in enumerate(run["recs"]):
        got = rec[case]
        for k, shape in whole.items():
            want = _expected_shape(shape, tp, r % tp)
            assert got["shapes"][k] == want, (r, k)
            assert got["buffers"][k] == {"trace": want}, (r, k)
            kinds.add("replicated" if want == list(shape) else
                      "row" if len(shape) == 3 and want[1] != shape[1] else "other")
    assert {"replicated", "row", "other"} <= kinds
    # only biases, group-norm gammas and betas and the vertex bias are
    # gathered whole: no conv weight or dense kernel for its product
    for rec in run["recs"]:
        gathered = set(rec[case]["gathered"])
        assert gathered and not [k for k in gathered if k.endswith((".w", ".kernel"))], gathered
        assert all(k.endswith((".b", ".bias", ".gamma", ".beta")) for k in gathered), gathered
    for lead in range(0, dp * tp, tp):   # each model group's first rank
        grads = {k: v for k, v in run["arrays"][lead].items() if k.startswith(case + "/grad/")}
        assert grads
        for r in range(lead + 1, lead + tp):
            for k, v in grads.items():
                np.testing.assert_array_equal(run["arrays"][r][k], v, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("tp", [2, 4])
def test_each_rank_routes_what_chip_smoke_derives(two, four, tp, monkeypatch):
    """The convs each rank of a (1, tp) mesh sends to the v3 route, as (B,
    C, F), are those chip_smoke.py's tp_routes derives from the weights'
    full shapes, JAX's leaf rule and the gate (lowered to GATE for the tiny
    model): the column-parallel products at F = fout / tp on the whole x,
    a row-parallel folded conv on the rank's share of x's channels (none on
    the ranks that hold only condition rows)."""
    from chip_smoke import tp_routes
    from cape_tpu_torch.ops import cheb

    for k, v in GATE.items():
        monkeypatch.setattr(cheb, k, v)
    cfg, ctx, _ = _setup()
    params = {k: tuple(p.shape) for k, p in _model(cfg, ctx).named_parameters()}
    run = two if tp == 2 else four
    seen = [rec[f"routes/{tp}"] for rec in run["recs"]]
    for r, got in enumerate(seen):
        assert [tuple(v) for v in got] == tp_routes(params, cfg, 16, tp, r), r
    # a row-parallel folded conv (the output conv at tp = 2, layer6 at 4)
    # convolves x on rank 0 only
    assert len(seen[0]) == len(seen[1]) + 1 and all(len(g) == len(seen[1]) for g in seen[1:])


def test_sharded_clip_matches_the_whole_one(two):
    """Each player's clip by global norm on (1, 2): the update of seeded
    gradients 100x N(0, 1) (norms far above 5, so both clips act) from each
    rank's shards, gathered, equals the single-process update of the whole
    gradients within 1e-6 of each leaf's max|update| (the sharded leaves'
    squares summed over the model group, the replicated ones counted
    once)."""
    for rec in two["recs"]:
        assert rec["clip"] <= 1e-6, rec["clip"]


def test_the_four_collectives_forward_and_backward(two):
    """copy, reduce, gather and scatter on 2 ranks in f64, forward and
    backward, against their definitions (an uneven scatter of [x | c]
    included, one rank taking no row of c)."""
    for rec in two["recs"]:
        for check, err in rec["collectives"].items():
            assert err <= 1e-12, (rec["rank"], check, err)


def test_mesh_fit_resume_and_checkpoint(four, tmp_path):
    """Trainer.fit on (2, 2) (2 epochs of 3 steps, the eval over the data
    groups, the checkpoint assembled whole) against the single-process fit:
    val losses and final parameters within 1e-4 relative; each rank trained
    its shards; the resume on (2, 2) continues to step 9, as JAX's; its
    checkpoint restores into a single-process Trainer bit-equal to the
    assembled full_state."""
    from cape_tpu_torch.train import checkpoint as ckpt
    from cape_tpu_torch.train.loop import Trainer

    recs = [rec["fit"] for rec in four["recs"]]
    assert all(r["val_recon"] == recs[0]["val_recon"] for r in recs)
    assert [r["step"] for r in recs] == [6] * 4 and [r["resume_end_step"] for r in recs] == [9] * 4
    cfg, ctx, data = _setup("tp_fit", num_epochs=2)
    single = Trainer(cfg.replace(data_parallel=0), _model(cfg, ctx), ctx, data,
                     workdir=str(tmp_path / "single"))
    val, _ = single.fit()
    np.testing.assert_allclose(recs[0]["val_recon"], val, rtol=1e-4, atol=1e-5)
    for k, v in single.model.state_dict().items():
        assert recs[1]["shapes"][k] == _expected_shape(tuple(v.shape), 2, 1), k
        for r in range(4):
            np.testing.assert_allclose(four["arrays"][r][f"fit/param/{k}"], v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=f"rank {r} {k}")
    assert os.listdir(four["out"] + ".workdir") == ["tp_fit"]
    restored = Trainer(cfg.replace(data_parallel=0, restart=False), _model(cfg, ctx), ctx, data,
                       workdir=four["out"] + ".workdir")
    assert restored.init_or_restore() == 9
    want = {k[len("resumed/"):]: v for k, v in four["arrays"][0].items()
            if k.startswith("resumed/")}
    got = ckpt.flatten_state(restored.state)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_mesh_predict_matches_the_single_process(four, tmp_path):
    """Trainer.predict on (2, 2) after the fit (8 test rows at global batch
    16: each data group computes its 8 rows of the padded batch, and every
    rank returns all 8) against a single-process Trainer's predict from the
    assembled parameters, within 1e-5 * max|ref|."""
    from cape_tpu_torch.train.loop import Trainer

    cfg, ctx, data = _setup("tp_fit", num_epochs=2)
    model = _model(cfg, ctx)
    model.load_state_dict({k[len("fit/param/"):]: torch.from_numpy(v)
                           for k, v in four["arrays"][0].items() if k.startswith("fit/param/")})
    single = Trainer(cfg.replace(data_parallel=0), model, ctx, data, workdir=str(tmp_path))
    want = single.predict(*data.split("test"))
    assert want.shape == (8, ctx.level_sizes[0], 3)
    for r in range(4):
        got = four["arrays"][r]["fit/predict"]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"rank {r}")


def test_trainer_predict_matches_jax(tmp_path):
    """Trainer.predict on the tiny model (20 rows at batch 8: a padded tail
    batch of 4) against JAX's Trainer.predict from the same parameters and
    rng: each batch's eps from fold_in(rng, begin), predictions back in the
    natural vertex order, within 1e-4 * max|ref|. Trainer.evaluate draws
    JAX's eval noise too: it equals JAX's evaluate under fold_in(PRNGKey(seed),
    key) within 1e-4 relative."""
    import jax

    from cape_tpu.core.config import CAPEConfig as JaxConfig
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.meshops.toy import icosphere
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu.ops.sparse import build_graph_context
    from cape_tpu.train.loop import Trainer as JaxTrainer
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.train.loop import Trainer

    cfg, ctx, _ = _setup("predict", batch_size=8, data_parallel=0)
    data = synthetic_bodydata(n_train=16, n_test=20, num_verts=ctx.level_sizes[0], seed=3,
                              n_val=8)
    model = _model(cfg, ctx)
    trainer = Trainer(cfg, model, ctx, data, workdir=str(tmp_path / "port"))
    disp, pose, clo = data.split("test")
    assert len(disp) == 20
    got = trainer.predict(disp, pose, clo, rng=prng.PRNGKey(3))

    verts, faces = icosphere(3)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "name", "nf", "nz", "nz_cond", "nz_cond2", "use_res_block", "use_res_block_dec",
        "affine", "reduce_dim", "batch_size")}, data_parallel=1)
    jctx = build_graph_context(build_pyramid(verts, faces, jcfg.ds_factors),
                               build_pyramid(verts, faces, [2, 2, 2, 2]),
                               vertices_per_edge(faces, len(verts)), verts,
                               padded=jcfg.padded_layout)
    jtrainer = JaxTrainer(jcfg, JaxCAPE(jcfg), jctx, data, workdir=str(tmp_path / "jax"))
    params = jax.tree_util.tree_map(np.asarray, to_jax_params(model))

    class State:
        pass

    state = State()
    state.params = params
    want = jtrainer.predict(disp, pose, clo, state=state, rng=jax.random.PRNGKey(3))
    assert got.shape == want.shape == (20, ctx.level_sizes[0], 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())

    jval = jtrainer.evaluate("val", state=state,
                             rng=jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 7))
    val = trainer.evaluate("val", key=7)
    assert val.keys() == jval.keys()
    for k in val:
        np.testing.assert_allclose(val[k], jval[k], rtol=1e-4, err_msg=k)


if __name__ == "__main__":   # python tests/test_torch_mesh2d.py worker MODE OUT RANK N PORT
    _worker(sys.argv[2], sys.argv[3], *map(int, sys.argv[4:7]))
