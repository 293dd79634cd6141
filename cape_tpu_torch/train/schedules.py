"""Learning-rate schedules.

Counterpart of `cape_tpu.train.schedules`: optional linear warmup over 8
epochs, then staircase exponential decay
lr * decay_rate^floor((step - warmup_steps)/decay_steps). Computed in
float32, as the JAX schedule is, so both give the same lr at every step.
"""

from __future__ import annotations

import numpy as np

WARMUP_EPOCHS = 8  # reference warmup_duration


def cape_schedule(base_lr: float, decay_steps: int, decay_rate: float = 0.99,
                  warmup_steps: int = 0):
    """Returns schedule(step) -> lr (a float32 scalar)."""
    decay_steps = max(int(decay_steps), 1)
    f32 = np.float32

    def schedule(step) -> np.float32:
        step = f32(step)
        if warmup_steps <= 0:
            return f32(base_lr) * f32(decay_rate) ** np.floor(step / f32(decay_steps))
        if step < warmup_steps:
            return f32(base_lr) * step / f32(warmup_steps)
        return f32(base_lr) * f32(decay_rate) ** np.floor(
            (step - f32(warmup_steps)) / f32(decay_steps)
        )

    return schedule
