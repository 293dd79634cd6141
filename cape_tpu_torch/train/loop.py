"""The training loop.

Counterpart of `cape_tpu.train.loop.Trainer`: the train split lives on the
device in the banded (RCM) vertex order and each step's batch is gathered
there from two [batch] index vectors; G and D draw from independent index
streams (seeds `seed` and `seed + 1`). The steps go in chunks of
`steps_per_dispatch` (cut at each epoch end), as JAX's scanned dispatch
goes, and each chunk's losses are screened for non-finite values at its end
(the one host sync of the loop); the val split is evaluated and the whole
train state checkpointed at each epoch end, metrics go to
`<workdir>/<name>/metrics.jsonl` (and, with cfg.tensorboard, to TensorBoard
events beside it, with each checkpoint's parameter histograms), and a
finished run draws its dashboard (`tools.plot_metrics`).

Restart semantics follow the reference (lib/models.py:852-866), as the JAX
package's: restart=True wipes the run directory; restart=False resumes from
the newest checkpoint (the port's or the JAX package's), skips both index
streams to its step and trains cfg.num_epochs more epochs, so a run
stopped and resumed takes the steps an uninterrupted run takes.
cfg.profile_steps > 0 captures whole chunks with torch.profiler, from the
run's second chunk (its first if the run is one chunk) until that many
steps are covered, as JAX's does (`<run>/profile/trace.json`); the trace
names each chunk's and each step's phases (`train.metrics.TRAIN_SPANS`).

The random draws are JAX's (`core.prng`), so a run from seed s is the JAX
package's run from seed s, given the parameters of init_params(PRNGKey(s))
(apps.main draws them so). Step s's reparameterization noise is
normal(fold_in(PRNGKey(seed), s), (batch_size, nz)) in the compute dtype,
as JAX's scanned step draws it; a chunk's k steps are drawn on the host in
one call and reach the device in one copy (non-blocking, from pinned
memory, on CUDA). The eval noise of the batch at row offset `begin` of an
evaluation keyed `key` is normal(fold_in(fold_in(PRNGKey(seed), key),
begin)), which is what JAX's fit gives its evaluate, and `predict` draws
normal(fold_in(rng, begin)), as JAX's predict does; both in the compute
dtype too.

Data parallelism (`dp`, a `parallel.mesh.DataParallel` over a process
group; built over the default group when one is initialised): every rank
holds the train split and the same parameters, gathers its rows
(`local_rows`) of each global batch from the global index streams, takes
its rows of each step's global noise (JAX's partitionable threefry gives
the global array whatever the sharding), and the train step
averages the ranks' gradients, so every rank applies the single-process
run's update (up to the order of float sums). The metrics that are read
are reduced over the ranks: the losses at each screen (so every rank
raises together), the metrics at each log point, the per-sample eval
metrics (`all_gather_rows`). Only the lead rank touches the filesystem:
the wipe on restart, metrics.jsonl and TensorBoard, checkpoints (a failed
write is broadcast, so every rank raises), the profile and the dashboard;
on resume the lead restores and broadcasts the parameters, the optimizer
state and the step.

Tensor parallelism (`dp`, a `parallel.mesh2d.MeshParallel`) goes through
the same seam: rows, the gradient mean and the metric reductions run over
the rank's data group, and after the lead's restore and broadcast
(`init_or_restore`) each rank keeps its shard of every sharded parameter
and optimizer buffer (`shard_state`); a checkpoint is written from the
whole state, which every rank helps assemble (`full_state`), in the same
format as a single process's.

Not ported: the K-step scan of the JAX package (it exists to save round
trips to a remote TPU); a chunk's steps are launched one after another.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from cape_tpu_torch.core import prng
from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.data.loader import BatchStream, BodyData
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.ops.sparse import GraphContext
from cape_tpu_torch.parallel.mesh import DataParallel
from cape_tpu_torch.tools.plot_metrics import plot_metrics
from cape_tpu_torch.train import checkpoint as ckpt
from cape_tpu_torch.train.metrics import MetricsLogger, profile_steps, span
from cape_tpu_torch.train.optim import Optimizer
from cape_tpu_torch.train.step import TrainState, eval_step, train_step


def to_device(draw: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A host draw (`core.prng`: float32 holding `dtype`'s values) as a
    `dtype` tensor on `device`, in one copy: on CUDA a non-blocking one from
    pinned memory, so the host does not wait for the device."""
    t = torch.from_numpy(np.ascontiguousarray(draw)).to(dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def step_noise(seed: int, steps, shape, dtype: torch.dtype, device, rows=slice(None)):
    """JAX's train-step noise of each step s of `steps`: normal(fold_in(
    PRNGKey(seed), s), shape, dtype), stacked [len(steps), *shape], rows
    `rows` of each, drawn in one call and on `device` in one copy."""
    draw = prng.normal_folded(prng.PRNGKey(seed), steps, shape, dtype)
    return to_device(draw[:, rows], dtype, device)


def eval_noise(key: np.ndarray, begin: int, shape, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """JAX's eval noise for the batch at row offset `begin`:
    normal(fold_in(key, begin), shape, dtype), on `device`."""
    return to_device(prng.normal(prng.fold_in(key, begin), shape, dtype), dtype, device)


def default_dp(cfg: CAPEConfig, device) -> DataParallel:
    """The Trainer's data parallelism when none is given: over the default
    process group if one is initialised (cfg.data_parallel, if > 0, must be
    its size), else this process's one device (cfg.data_parallel > 1 then
    asks for more devices than the process drives, and raises). The group's
    size must divide the batch."""
    if dist.is_initialized():
        dp = DataParallel(cfg.data_parallel, devices=[device], group=dist.group.WORLD)
    else:
        dp = DataParallel(cfg.data_parallel, devices=[device])
    if cfg.batch_size % dp.num_devices:
        raise ValueError(
            f"data_parallel={dp.num_devices} does not divide batch_size="
            f"{cfg.batch_size}; the batch axis is sharded evenly across the mesh"
        )
    return dp


class Trainer:
    def __init__(
        self,
        cfg: CAPEConfig,
        model: CAPE,
        ctx: GraphContext,
        data: BodyData,
        workdir: str = "results",
        dp: DataParallel | None = None,
    ):
        if not cfg.name:
            raise ValueError("config.name must be set (run/checkpoint identity)")
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.dp = default_dp(cfg, self.device) if dp is None else dp
        if self.dp.devices != [self.device]:
            raise ValueError(f"the model is on {self.device}, the rank's device is "
                             f"{self.dp.devices}")
        # multi-process runs: every rank computes; only the lead touches the
        # filesystem (the wipe, metrics, checkpoints, profile, dashboard)
        self.lead = self.dp.lead
        self.rows = self.dp.local_rows(cfg.batch_size)
        self.model = model
        self.ctx = ctx.to(self.device)
        self.data = data
        self.run_dir = os.path.join(workdir, cfg.name)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        self.steps_per_epoch = max(len(data.disp_train) // cfg.batch_size, 1)
        self.num_steps = cfg.num_epochs * self.steps_per_epoch
        self.state = TrainState(model, Optimizer(cfg, self.steps_per_epoch))
        self.train_data = self._on_device("train")
        self._val_data = None

    def _on_device(self, split: str) -> dict[str, torch.Tensor]:
        """A split's arrays on the device, vertices in the context's order."""
        disp, pose, clo = self.data.split(split)
        if self.ctx.perm0 is not None:
            disp = disp[:, self.ctx.perm0]
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return {"disp": dev(disp), "pose": dev(pose), "clo": dev(clo)}

    def _gather(self, idx_g: np.ndarray, idx_d: np.ndarray) -> dict[str, torch.Tensor]:
        with span("train.gather"):
            ig = torch.from_numpy(idx_g).to(self.device)
            idd = torch.from_numpy(idx_d).to(self.device)
            out = {}
            for k, v in self.train_data.items():
                out[f"{k}_g"] = v.index_select(0, ig)
                out[f"{k}_d"] = v.index_select(0, idd)
        return out

    def run_steps(self, k: int, stream_g: BatchStream, stream_d: BatchStream) -> list[dict]:
        """k train steps back to back, each on a batch gathered on the device
        by the next indices of the G and D streams, with JAX's noise of its
        step (`step_noise`: the k steps' noise drawn on the host in one call
        and copied in one); no host sync. Under data parallelism each rank
        takes its rows of the global batch and of the global noise, and the
        ranks' gradients are averaged. Returns each step's metrics (device
        tensors, this rank's own). Trainer.fit takes its steps here, as does
        the lab's `step` and `trace` (tools.perf_lab). Under a profiler the
        noise draw is the span train.noise, each step train.step, holding
        the step's train.gather and `train_step`'s phases
        (`train.metrics.TRAIN_SPANS`)."""
        cfg = self.cfg
        lo, hi = self.rows
        reduce = None if self.dp.group is None else self.dp.all_reduce_mean
        step = self.state.step
        with span("train.noise"):
            eps = step_noise(cfg.seed, range(step, step + k), (cfg.batch_size, cfg.nz),
                             self.model.dtype, self.device, slice(lo, hi))
        out = []
        for i in range(k):
            with span("train.step"):
                batch = self._gather(stream_g.next_indices()[lo:hi],
                                     stream_d.next_indices()[lo:hi])
                metrics, _ = train_step(self.state, self.ctx, batch, eps[i], reduce=reduce)
            out.append(metrics)
        return out

    def init_or_restore(self) -> int:
        """restart=True wipes the run directory; restart=False restores the
        newest readable checkpoint into the train state. Returns the step
        the run starts at. Under data parallelism the lead alone wipes (the
        others wait for it) or restores, and broadcasts what it restored:
        the parameters, every optimizer buffer and count, and the step (the
        parameters also when it restored nothing, so that every rank starts
        from the lead's). Then each rank keeps its shard of the state
        (`shard_state`: a no-op but under tensor parallelism); a state sharded
        by an earlier call is first made whole again."""
        dp = self.dp
        self.state = dp.full_state(self.state)
        self.model = self.state.model
        if self.cfg.restart:
            if self.lead:
                shutil.rmtree(self.run_dir, ignore_errors=True)
                os.makedirs(self.ckpt_dir, exist_ok=True)
            dp.barrier()
        else:
            path = ckpt.restore_latest(self.ckpt_dir, self.state) if self.lead else None
            if path is not None:
                print(f"resumed from {path} at step {self.state.step}", flush=True)
            if dp.group is not None:
                tx = self.state.tx
                restored, self.state.step, tx.count["g"], tx.count["d"] = dp.broadcast_ints(
                    [path is not None, self.state.step, tx.count["g"], tx.count["d"]])
                if restored:
                    dp.replicate(tx.state_tensors(dict(self.model.named_parameters())))
        if dp.group is not None:
            dp.replicate(self.model)
        dp.shard_state(self.state)
        return self.state.step

    def _save_checkpoint(self, step: int) -> None:
        """The lead writes the checkpoint (and the parameter histograms) of
        the whole state, which every rank helps assemble under tensor
        parallelism; under data parallelism its failure is broadcast, so
        that every rank raises instead of waiting in the next step's
        collective."""
        err = None
        state = self.dp.full_state(self.state)
        if self.lead:
            try:
                ckpt.save_checkpoint(self.ckpt_dir, state, step, keep=self.cfg.checkpoint_keep)
                if self._logger.tb is not None:
                    self._logger.tb.add_param_histograms(step, state.model.state_dict())
            except Exception as e:  # raised below, after every rank has heard of it
                err = e
        if self.dp.group is not None and not self.dp.broadcast_ints([err is None])[0]:
            if err is not None:
                raise err
            raise RuntimeError("checkpoint write failed on the lead process")
        if err is not None:
            raise err

    def fit(self):
        """Train for cfg.num_epochs (more, on a resumed run). Returns (val
        recon losses, sec/step)."""
        cfg = self.cfg
        seed = cfg.seed
        start_step = self.init_or_restore()
        logger = self._logger = MetricsLogger(self.run_dir, tensorboard=cfg.tensorboard,
                                              write=self.lead)
        n = len(self.data.disp_train)
        stream_g = BatchStream(n, cfg.batch_size, seed)
        stream_d = BatchStream(n, cfg.batch_size, seed + 1)
        # the batches an uninterrupted run would take from here
        stream_g.skip(start_step)
        stream_d.skip(start_step)
        chunk = max(1, cfg.steps_per_dispatch)
        end_step = start_step + self.num_steps

        val_losses = []
        t_start = time.time()
        t_mark, steps_since = time.perf_counter(), 0
        profiler = contextlib.ExitStack()
        profiled = 0
        step = start_step
        try:
            while step < end_step:
                done = step - start_step
                # chunks of steps_per_dispatch steps, cut at each epoch end
                n = min(chunk, end_step - step, self.steps_per_epoch - done % self.steps_per_epoch)
                # the trace takes whole chunks after the run's first (cold)
                # one, unless the run is one chunk, as JAX's does
                capture = (self.lead and profiled < cfg.profile_steps
                           and (done > 0 or self.num_steps <= n))
                if capture and profiled == 0:
                    profiler.enter_context(profile_steps(os.path.join(self.run_dir, "profile")))
                metrics = self.run_steps(n, stream_g, stream_d)
                if capture:
                    profiled += n
                    if profiled >= cfg.profile_steps:
                        profiler.close()
                self._screen([(step + i, torch.stack([m["loss_g"], m["loss_d"]]))
                              for i, m in enumerate(metrics)])
                for i, m in enumerate(metrics):
                    if cfg.log_every_steps and (step + i) % cfg.log_every_steps == 0:
                        logger.log(step + i, self.dp.all_reduce_mean(m))  # the global batch's
                step += n
                steps_since += n
                done += n
                if done % self.steps_per_epoch and step != end_step:
                    continue
                step_ms = 1000.0 * (time.perf_counter() - t_mark) / steps_since
                epoch = done // self.steps_per_epoch
                m = {k: float(v) for k, v in self.dp.all_reduce_mean(metrics[-1]).items()}
                m["loss_g_ema"] = logger.ema_g.update(m["loss_g"])
                m["loss_d_ema"] = logger.ema_d.update(m["loss_d"])
                val = self.evaluate("val", 1_000_000_000 + epoch)
                val_losses.append(val["recon"])
                m.update({f"val_{k}": v for k, v in val.items()})
                m["epoch"] = epoch
                # the lr of this step's update: the schedule at the count before it
                m["lr_g"] = float(self.state.tx.sched["g"](self.state.tx.count["g"] - 1))
                m["sec_per_step"] = (time.time() - t_start) / done
                m["step_ms"] = step_ms  # train steps only: no eval, no checkpoint
                logger.log(step - 1, m, echo=True)
                self._save_checkpoint(step)
                t_mark, steps_since = time.perf_counter(), 0
        finally:
            profiler.close()
            logger.close()
        if val_losses and self.lead:  # an epoch ended, so metrics.jsonl has a record
            plot_metrics(self.run_dir)
        return val_losses, (time.time() - t_start) / max(self.num_steps, 1)

    def _screen(self, pending: list[tuple[int, torch.Tensor]]) -> None:
        """Fail fast, naming the step, on a non-finite loss: a NaN that keeps
        training poisons every later checkpoint."""
        with span("train.screen"):
            losses = self.dp.all_reduce_mean([torch.stack([v for _, v in pending])])[0]
            losses = losses.cpu().numpy()
        bad = ~np.isfinite(losses).all(axis=1)
        if bad.any():
            i = int(np.argmax(bad))
            raise FloatingPointError(
                f"non-finite training loss at step {pending[i][0]} "
                f"(loss_g={losses[i, 0]}, loss_d={losses[i, 1]}); inspect the data/lr; "
                f"latest good checkpoint: {ckpt.latest_checkpoint(self.ckpt_dir)}"
            )

    def evaluate(self, split: str = "val", key: int = 0,
                 rng: np.ndarray | None = None) -> dict[str, float]:
        """Mean per-sample recon/kl/edge over a split, in batches of
        cfg.batch_size; the tail batch is padded with zero rows, which are
        dropped before the mean. The noise of the batch at row offset
        `begin` is JAX's eval noise (`eval_noise`) under `rng` (a
        `core.prng` key, as JAX's evaluate takes it), by default
        fold_in(PRNGKey(seed), key). Under data parallelism
        each rank evaluates its rows of each padded batch and
        `all_gather_rows` brings every rank's per-sample metrics to all."""
        cfg = self.cfg
        if split == "val":
            if self._val_data is None:
                self._val_data = self._on_device("val")
            data = self._val_data
        else:
            data = self._on_device(split)
        if rng is None:
            rng = prng.fold_in(prng.PRNGKey(cfg.seed), key)
        sums: dict[str, float] = {}
        with torch.inference_mode():
            for rows, batch, eps in self._padded_batches(data, rng):
                _, metrics = eval_step(self.model, cfg, self.ctx, batch, eps)
                metrics = self.dp.all_gather_rows(metrics, cfg.batch_size)
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + float(v[:rows].double().sum())
        n = len(data["disp"])
        return {k: v / max(n, 1) for k, v in sums.items()}

    def predict(self, disp, pose, clo, rng: np.ndarray | None = None) -> np.ndarray:
        """Batched full-dataset autoencoding forward (the reference's
        predict, as JAX's Trainer.predict): disp [N, V, 3] in the natural
        vertex order, in batches of cfg.batch_size with a zero-padded tail
        batch, each batch's eps JAX's (`eval_noise`) under `rng` (a
        `core.prng` key; default PRNGKey(0)). Returns the normalized-space
        predictions [N, V, 3] f32 in the natural vertex order, on every rank:
        each rank computes its rows of each batch and `all_gather_rows`
        brings them to all."""
        perm = self.ctx.perm0
        disp = np.asarray(disp, np.float32)
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
        data = {"disp": dev(disp if perm is None else disp[:, perm]), "pose": dev(pose),
                "clo": dev(clo)}
        outs = []
        with torch.inference_mode():
            for rows, batch, eps in self._padded_batches(
                    data, prng.PRNGKey(0) if rng is None else rng):
                pred, _ = eval_step(self.model, self.cfg, self.ctx, batch, eps)
                pred = self.dp.all_gather_rows({"pred": pred}, self.cfg.batch_size)["pred"]
                outs.append(pred[:rows].cpu().numpy())
        out = np.concatenate(outs, axis=0)
        return out if perm is None else np.ascontiguousarray(out[:, np.argsort(perm)])

    def _padded_batches(self, data: dict[str, torch.Tensor], rng: np.ndarray):
        """For each batch of cfg.batch_size rows of `data` (the tail batch
        padded with zero rows): its number of real rows, this rank's rows of
        it and of its noise, JAX's eval noise under `rng` (`eval_noise`, in
        the compute dtype)."""
        bs = self.cfg.batch_size
        lo, hi = self.rows
        for begin in range(0, len(data["disp"]), bs):
            rows = min(bs, len(data["disp"]) - begin)
            batch = {k: torch.cat([v[begin: begin + rows],
                                   v.new_zeros((bs - rows,) + v.shape[1:])])[lo:hi]
                     for k, v in data.items()}
            eps = eval_noise(rng, begin, (bs, self.cfg.nz), self.device, self.model.dtype)
            yield rows, batch, eps[lo:hi]
