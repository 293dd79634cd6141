"""Metrics of a training run, and its trace capture.

Counterpart of `cape_tpu.train.metrics`: console lines, an append-only
JSONL metrics file per run, EMA-smoothed G/D losses (the reference's
ExponentialMovingAverage(0.9)), an optional TensorBoard mirror of every
logged scalar (`train.tb_events`), `profile_steps`, a torch.profiler
context over CPU and CUDA activity that writes a Chrome trace, and, from
`core.spans`, `span`, the named phases of a train step that such a trace
shows (`TRAIN_SPANS`) and of the model's parts (`MODEL_SPANS`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import torch

from cape_tpu_torch.core.spans import MODEL_SPANS, TRAIN_SPANS, span  # noqa: F401 (re-exported)
from cape_tpu_torch.train.tb_events import TBEventWriter, tb_tag


class EMA:
    """Exponential moving average, decay 0.9 like the reference."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.value: float | None = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else self.decay * self.value + (1 - self.decay) * x
        return self.value


class MetricsLogger:
    """Append-only JSONL metrics of a run, with EMA-smoothed G/D losses.
    tensorboard=True also mirrors every logged scalar into a TensorBoard
    event file in run_dir (`self.tb`, which also takes the checkpoints'
    parameter histograms). write=False (a data-parallel run's ranks but the
    lead) keeps the EMAs and writes and prints nothing."""

    def __init__(self, run_dir: str, filename: str = "metrics.jsonl", tensorboard: bool = False,
                 write: bool = True):
        self.path = os.path.join(run_dir, filename)
        self._fh = self.tb = None
        if write:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(self.path, "a")
            self.tb = TBEventWriter(run_dir) if tensorboard else None
        self.ema_g = EMA()
        self.ema_d = EMA()
        self.t0 = time.time()

    def log(self, step: int, payload: dict[str, Any], echo: bool = False) -> None:
        if self._fh is None:
            return
        record = {"step": int(step), "t": round(time.time() - self.t0, 3)}
        record.update({k: float(v) if hasattr(v, "__float__") else v for k, v in payload.items()})
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self.tb is not None:
            self.tb.add_scalars(step, {
                tb_tag(k): float(v) for k, v in payload.items()
                if isinstance(v, (int, float)) or hasattr(v, "__float__")
            })
        if echo:
            print(" ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items() if k != "t"
            ), flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self.tb is not None:
            self.tb.close()


@contextlib.contextmanager
def profile_steps(log_dir: str):
    """Capture CPU and, where a GPU is present, CUDA activity of the enclosed
    steps; on exit, write it as a Chrome trace `trace.json` under log_dir
    (open it in chrome://tracing or Perfetto). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the enclosed steps' kernels end inside the capture
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
