"""Named spans of the port's work in a running profiler's trace.

`span(name)` is what the train loop and the model wrap their phases in;
`TRAIN_SPANS` names the phases of a train step (`train.loop`,
`train.step`) and `MODEL_SPANS` the model's parts (`models.cape`). It
lives here, below both, so that the model needs nothing of the train
package; `train.metrics` re-exports it.
"""

from __future__ import annotations

import contextlib

import torch

# The phases of `Trainer.run_steps`, each a `span` on the calling thread:
# a chunk's noise draw and its loss screen, and per step the step itself
# and, inside it in turn, its batch gather, the GAN forward, the backward,
# the gradient mean over the ranks (under data parallelism only) and the
# optimizer with the in-place parameter update.
TRAIN_SPANS = ("train.noise", "train.step", "train.gather", "train.forward", "train.backward",
               "train.reduce", "train.optimizer", "train.screen")
# The model's own spans, on the thread that calls it: `CAPE.encode`'s
# forward (in a train step, inside `train.forward`).
MODEL_SPANS = ("model.encode",)
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context naming the enclosed work `name` in a running profiler's
    trace (a `record_function`, shown as a `user_annotation` event on the
    calling thread's timeline); while no profiler runs, a shared null
    context. The gate is the flag torch.profiler sets for the process: a
    `record_function` costs microseconds even with the profiler off."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
