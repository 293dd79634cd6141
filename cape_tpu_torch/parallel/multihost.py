"""Multi-process data parallelism: one process per device over
`torch.distributed`.

Counterpart of `cape_tpu.parallel.multihost`. Every process calls
:func:`initialize` and joins one process group; :class:`MultiHostDataParallel`
is `parallel.mesh.DataParallel` over that group. Each process holds the
whole train split on its device and feeds only its rows of each global
batch (`local_rows`): the index streams are seed-deterministic, so every
process reconstructs the same global batch (the selftest hash-checks it),
as JAX's multi-controller recipe has every controller do. The train step
averages the ranks' gradients (`train.step.train_step`'s reducer), so
every rank applies the global batch's update.

Selftest, the tiny icosphere model on the CPU in N processes (Gloo):

    python -m cape_tpu_torch.parallel.multihost RANK N PORT [step|trainer]

`step` runs one global train step and prints the reduced metrics;
`trainer` runs a 2-epoch Trainer.fit, then resumes it for 1 epoch with the
non-lead ranks pointed at an empty workdir (the lead's restored state has
to reach them by broadcast). Each prints one `SELFTEST {json}` line, which
must be equal across the ranks.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from cape_tpu_torch.parallel.mesh import DataParallel

# how long a collective, and joining the group, may wait for the other ranks
TIMEOUT = datetime.timedelta(minutes=5)
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join (or create) the default process group. Idempotent.

    With a coordinator address ("host:port"), this process is rank
    `process_id` of `num_processes`; with none, the launcher's environment
    (`torchrun`: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) says so, and a
    process without it raises. `backend` None is NCCL where a GPU is
    present, else Gloo. A group that fails to form raises."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=TIMEOUT)
        return
    missing = [k for k in LAUNCHER_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"initialize(): no coordinator address and no launcher environment "
            f"({', '.join(missing)} unset); run under torchrun or pass the address"
        )
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)


def launched() -> bool:
    """Whether a launcher (torchrun) started this process as a rank."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def rank_device(device_type: str) -> torch.device:
    """This rank's device: cuda:LOCAL_RANK (modulo the GPUs present), or the
    CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


class MultiHostDataParallel(DataParallel):
    """DataParallel over the default process group (every process of the
    run), this process driving `device` (default: `rank_device`'s, CUDA
    where a GPU is present)."""

    def __init__(self, device=None):
        if not dist.is_initialized():
            raise RuntimeError("MultiHostDataParallel needs initialize() first")
        if device is None:
            device = rank_device("cuda" if torch.cuda.is_available() else "cpu")
        super().__init__(devices=[device], group=dist.group.WORLD)


# ----------------------------------------------------------------- selftest
def _tiny(name: str, n_procs: int, **overrides):
    """The selftest's config, context and data: the icosphere model cut to
    nf=4 (JAX's selftest model), global batch 8 per process (16 on 2, as
    JAX's 2 x 4 devices), 64 synthetic samples of which 16 validate."""
    from cape_tpu_torch.core.config import CAPEConfig
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.meshops.pyramid import build_pyramid
    from cape_tpu_torch.meshops.topology import vertices_per_edge
    from cape_tpu_torch.meshops.toy import icosphere
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = icosphere(3)
    nv = len(verts)
    cfg = CAPEConfig(
        name=name, nf=4, nz=8, nz_cond=8, nz_cond2=4, use_res_block=False,
        use_res_block_dec=True, affine=True, reduce_dim=8, batch_size=8 * n_procs,
        data_parallel=n_procs, **overrides,
    )
    pyr = build_pyramid(verts, faces, cfg.ds_factors)
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    ctx = build_graph_context(pyr, pyr_d, vertices_per_edge(faces, nv), verts,
                              padded=cfg.padded_layout)
    data = synthetic_bodydata(n_train=64, n_test=8, num_verts=nv, seed=0, n_val=16)
    return cfg, ctx, data


def _model(cfg, ctx, seed: int = 0):
    """The tiny model from PRNGKey(seed): JAX's selftest draws its step's
    parameters from PRNGKey(0), its Trainer.fit from PRNGKey(cfg.seed)."""
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.models.cape import CAPE

    return CAPE(cfg).init_params(prng.PRNGKey(seed), ctx)


def _selftest(rank: int, nprocs: int, port: int) -> None:
    """One global train step on the tiny model; prints one JSON metrics line,
    which must be equal on every rank."""
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.train.loop import to_device
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    initialize(f"localhost:{port}", nprocs, rank, backend="gloo")
    cfg, ctx, data = _tiny("multihost_selftest", nprocs)
    mh = MultiHostDataParallel(torch.device("cpu"))
    assert mh.num_devices == nprocs
    model = mh.replicate(_model(cfg, ctx))

    # every process reconstructs the same global batch; verify it is
    n = len(data.disp_train)
    ig = BatchStream(n, cfg.batch_size, 0).next_indices()
    idd = BatchStream(n, cfg.batch_size, 1).next_indices()
    disp = data.disp_train[:, ctx.perm0]
    host_batch = {"disp_g": disp[ig], "pose_g": data.pose_train[ig], "clo_g": data.clo_train[ig],
                  "disp_d": disp[idd], "pose_d": data.pose_train[idd],
                  "clo_d": data.clo_train[idd]}
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(host_batch[k]).tobytes()
                                     for k in sorted(host_batch))).digest()
    mine = int.from_bytes(digest[:7], "little")
    lead = mh.broadcast_ints([mine])[0]
    same = mh.all_reduce_mean([torch.tensor([float(mine == lead)])])[0]
    if float(same) != 1.0:
        raise AssertionError("the global batch differs across ranks")

    lo, hi = mh.local_rows(cfg.batch_size)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])) for k, v in host_batch.items()}
    # JAX's selftest steps with PRNGKey(2): eps = normal(PRNGKey(2), (B, nz))
    eps = to_device(prng.normal(prng.PRNGKey(2), (cfg.batch_size, cfg.nz))[lo:hi],
                    model.dtype, mh.device)
    state = TrainState(model, Optimizer(cfg, steps_per_epoch=10))
    metrics, _ = train_step(state, ctx, batch, eps, reduce=mh.all_reduce_mean)
    m = {k: round(float(v), 6) for k, v in mh.all_reduce_mean(metrics).items()}
    if not all(np.isfinite(v) for v in m.values()):
        raise FloatingPointError(m)
    print("SELFTEST " + json.dumps({"rank": rank, "metrics": m}), flush=True)


def _selftest_trainer(rank: int, nprocs: int, port: int) -> None:
    """A 2-epoch Trainer.fit of the tiny model (3 steps an epoch), then 1
    epoch resumed with the non-lead ranks pointed at an empty workdir;
    prints the per-epoch validation recon losses and the step the resumed
    run ends at (9)."""
    from cape_tpu_torch.train.loop import Trainer

    initialize(f"localhost:{port}", nprocs, rank, backend="gloo")
    cfg, ctx, data = _tiny("multihost_trainer", nprocs, num_epochs=2, log_every_steps=0,
                           steps_per_dispatch=3)
    mh = MultiHostDataParallel(torch.device("cpu"))
    workdir = os.path.join(tempfile.gettempdir(), f"cape_torch_mh_{port}")
    try:
        trainer = Trainer(cfg, _model(cfg, ctx, cfg.seed), ctx, data, workdir=workdir, dp=mh)
        val_losses, _ = trainer.fit()
        out = {"rank": rank, "val_recon": [round(float(v), 6) for v in val_losses]}
        if not all(np.isfinite(v) for v in out["val_recon"]):
            raise FloatingPointError(out)
        # divergent host filesystems: only the lead's workdir holds the
        # checkpoint; init_or_restore broadcasts the lead's restored state
        wd2 = workdir if mh.lead else workdir + f"_empty{rank}"
        cfg2 = cfg.replace(restart=False, num_epochs=1)
        trainer2 = Trainer(cfg2, _model(cfg2, ctx, cfg.seed), ctx, data, workdir=wd2, dp=mh)
        trainer2.fit()
        out["resume_end_step"] = trainer2.state.step
        mh.barrier()
    finally:
        shutil.rmtree(workdir if mh.lead else workdir + f"_empty{rank}", ignore_errors=True)
    print("SELFTEST " + json.dumps(out), flush=True)


if __name__ == "__main__":  # python -m cape_tpu_torch.parallel.multihost RANK N PORT [mode]
    torch.set_num_threads(1)
    fn = _selftest_trainer if "trainer" in sys.argv[4:] else _selftest
    try:
        fn(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
