"""The training loop.

Counterpart of `cape_tpu.train.loop.Trainer`: the train split lives on the
device in the banded (RCM) vertex order and each step's batch is gathered
there from two [batch] index vectors; G and D draw from independent index
streams (seeds `seed` and `seed + 1`); the reparameterization noise comes
from a `torch.Generator` on the device seeded from (seed, step). Losses are
screened for non-finite values at least every `steps_per_dispatch` steps
(the one host sync of the loop), the val split is evaluated and the whole
train state checkpointed at each epoch end, metrics go to
`<workdir>/<name>/metrics.jsonl` (and, with cfg.tensorboard, to TensorBoard
events beside it, with each checkpoint's parameter histograms), and a
finished run draws its dashboard (`tools.plot_metrics`).

Restart semantics follow the reference (lib/models.py:852-866), as the JAX
package's: restart=True wipes the run directory; restart=False resumes from
the newest checkpoint (the port's or the JAX package's), skips both index
streams to its step and trains cfg.num_epochs more epochs, so a run
stopped and resumed takes the steps an uninterrupted run takes.
cfg.profile_steps > 0 captures that many steps after the first of the run
with torch.profiler (`<run>/profile/trace.json`).

Not ported: the K-step scan of the JAX package (it exists to save round
trips to a remote TPU) and data parallelism.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np
import torch

from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.data.loader import BatchStream, BodyData
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.ops.sparse import GraphContext
from cape_tpu_torch.tools.plot_metrics import plot_metrics
from cape_tpu_torch.train import checkpoint as ckpt
from cape_tpu_torch.train.metrics import MetricsLogger, profile_steps
from cape_tpu_torch.train.optim import Optimizer
from cape_tpu_torch.train.step import TrainState, eval_step, train_step


def noise(shape, device, *key: int) -> torch.Tensor:
    """Standard-normal noise from a generator on `device` seeded from `key`
    (non-negative ints), e.g. (seed, step)."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def _unsupported(cfg: CAPEConfig) -> list[str]:
    return ["--data_parallel (one device per run)"] if cfg.data_parallel > 1 else []


class Trainer:
    def __init__(
        self,
        cfg: CAPEConfig,
        model: CAPE,
        ctx: GraphContext,
        data: BodyData,
        workdir: str = "results",
    ):
        if not cfg.name:
            raise ValueError("config.name must be set (run/checkpoint identity)")
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                "not ported to cape_tpu_torch yet: " + "; ".join(missing)
            )
        self.cfg = cfg
        self.device = next(model.parameters()).device
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
        ig = torch.from_numpy(idx_g).to(self.device)
        idd = torch.from_numpy(idx_d).to(self.device)
        out = {}
        for k, v in self.train_data.items():
            out[f"{k}_g"] = v.index_select(0, ig)
            out[f"{k}_d"] = v.index_select(0, idd)
        return out

    def init_or_restore(self) -> int:
        """restart=True wipes the run directory; restart=False restores the
        newest readable checkpoint into the train state. Returns the step
        the run starts at."""
        if self.cfg.restart:
            shutil.rmtree(self.run_dir, ignore_errors=True)
            os.makedirs(self.ckpt_dir, exist_ok=True)
        else:
            path = ckpt.restore_latest(self.ckpt_dir, self.state)
            if path is not None:
                print(f"resumed from {path} at step {self.state.step}", flush=True)
        return self.state.step

    def fit(self):
        """Train for cfg.num_epochs (more, on a resumed run). Returns (val
        recon losses, sec/step)."""
        cfg = self.cfg
        seed = cfg.seed
        start_step = self.init_or_restore()
        logger = MetricsLogger(self.run_dir, tensorboard=cfg.tensorboard)
        n = len(self.data.disp_train)
        stream_g = BatchStream(n, cfg.batch_size, seed)
        stream_d = BatchStream(n, cfg.batch_size, seed + 1)
        # the batches an uninterrupted run would take from here
        stream_g.skip(start_step)
        stream_d.skip(start_step)
        screen_every = max(1, cfg.steps_per_dispatch)
        eps_shape = (cfg.batch_size, cfg.nz)
        end_step = start_step + self.num_steps

        val_losses = []
        pending: list[tuple[int, torch.Tensor]] = []
        t_start = time.time()
        t_mark, steps_since = time.perf_counter(), 0
        profiler = contextlib.ExitStack()
        profiled = 0
        try:
            for step in range(start_step, end_step):
                done = step - start_step
                # the trace takes the steps after the run's first (cold) one,
                # unless the run has only one
                capture = profiled < cfg.profile_steps and (done > 0 or self.num_steps == 1)
                if capture and profiled == 0:
                    profiler.enter_context(profile_steps(os.path.join(self.run_dir, "profile")))
                batch = self._gather(stream_g.next_indices(), stream_d.next_indices())
                metrics, _ = train_step(
                    self.state, self.ctx, batch, noise(eps_shape, self.device, seed, step)
                )
                if capture:
                    profiled += 1
                    if profiled == cfg.profile_steps:
                        profiler.close()
                pending.append((step, torch.stack([metrics["loss_g"], metrics["loss_d"]])))
                steps_since += 1
                epoch_end = (done + 1) % self.steps_per_epoch == 0 or step + 1 == end_step
                if len(pending) >= screen_every or epoch_end:
                    self._screen(pending)
                    pending = []
                if cfg.log_every_steps and step % cfg.log_every_steps == 0:
                    logger.log(step, metrics)
                if not epoch_end:
                    continue
                step_ms = 1000.0 * (time.perf_counter() - t_mark) / steps_since
                epoch = (done + 1) // self.steps_per_epoch
                m = {k: float(v) for k, v in metrics.items()}
                m["loss_g_ema"] = logger.ema_g.update(m["loss_g"])
                m["loss_d_ema"] = logger.ema_d.update(m["loss_d"])
                val = self.evaluate("val", 1_000_000_000 + epoch)
                val_losses.append(val["recon"])
                m.update({f"val_{k}": v for k, v in val.items()})
                m["epoch"] = epoch
                # the lr of this step's update: the schedule at the count before it
                m["lr_g"] = float(self.state.tx.sched["g"](self.state.tx.count["g"] - 1))
                m["sec_per_step"] = (time.time() - t_start) / (done + 1)
                m["step_ms"] = step_ms  # train steps only: no eval, no checkpoint
                logger.log(step, m, echo=True)
                ckpt.save_checkpoint(self.ckpt_dir, self.state, step + 1, keep=cfg.checkpoint_keep)
                if logger.tb is not None:
                    logger.tb.add_param_histograms(step + 1, self.model.state_dict())
                t_mark, steps_since = time.perf_counter(), 0
        finally:
            profiler.close()
            logger.close()
        if val_losses:  # an epoch ended, so metrics.jsonl has a record
            plot_metrics(self.run_dir)
        return val_losses, (time.time() - t_start) / max(self.num_steps, 1)

    def _screen(self, pending: list[tuple[int, torch.Tensor]]) -> None:
        """Fail fast, naming the step, on a non-finite loss: a NaN that keeps
        training poisons every later checkpoint."""
        losses = torch.stack([v for _, v in pending]).cpu().numpy()
        bad = ~np.isfinite(losses).all(axis=1)
        if bad.any():
            i = int(np.argmax(bad))
            raise FloatingPointError(
                f"non-finite training loss at step {pending[i][0]} "
                f"(loss_g={losses[i, 0]}, loss_d={losses[i, 1]}); inspect the data/lr; "
                f"latest good checkpoint: {ckpt.latest_checkpoint(self.ckpt_dir)}"
            )

    def evaluate(self, split: str = "val", key: int = 0) -> dict[str, float]:
        """Mean per-sample recon/kl/edge over a split, in batches of
        cfg.batch_size; the tail batch is padded with zero rows, which are
        dropped before the mean. The noise of the batch at row offset
        `begin` is seeded from (seed, key, begin)."""
        cfg = self.cfg
        if split == "val":
            if self._val_data is None:
                self._val_data = self._on_device("val")
            data = self._val_data
        else:
            data = self._on_device(split)
        n, bs = len(data["disp"]), cfg.batch_size
        sums: dict[str, float] = {}
        with torch.inference_mode():
            for begin in range(0, n, bs):
                rows = min(bs, n - begin)
                batch = {
                    k: torch.cat([v[begin : begin + rows], v.new_zeros((bs - rows,) + v.shape[1:])])
                    for k, v in data.items()
                }
                eps = noise((bs, cfg.nz), self.device, cfg.seed, key, begin)
                _, metrics = eval_step(self.model, cfg, self.ctx, batch, eps)
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + float(v[:rows].double().sum())
        return {k: v / max(n, 1) for k, v in sums.items()}
