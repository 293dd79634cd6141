"""The two players' optimizer.

Counterpart of `cape_tpu.train.optim` (an optax.multi_transform there),
written by hand on tensors with optax's semantics, so that one update
matches optax's: separate G and D players, SGD with momentum (optax
`trace`) or Adam, lr_d = lr * lr_scaler on the shared schedule, taken at
optax's count (the number of updates before this one), and each player's
gradients clipped by the player's own global norm of 5.0 with optax's
formula g * 5 / |g| when |g| >= 5 (no epsilon). G's parameters are the
generator and the condition nets (frozen, with zero updates, when
optim_condnet is off); D's are the discriminator's.
"""

from __future__ import annotations

import numpy as np
import torch

from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.train.schedules import WARMUP_EPOCHS, cape_schedule

GRAD_CLIP_NORM = 5.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam defaults


def param_labels(params: dict, optim_condnet: bool = True) -> dict[str, str]:
    """'g', 'd' or 'frozen' per top-level parameter group."""
    labels = {}
    for k in params:
        if k == "discriminator":
            labels[k] = "d"
        elif k in ("cond_pose", "cond_clo"):
            labels[k] = "g" if optim_condnet else "frozen"
        else:
            labels[k] = "g"
    return labels


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """Both players' optimizer state (update counts and moment buffers,
    f32) and its update. update() maps gradients keyed by dotted parameter
    path (`discriminator.layer0.w`) to updates, as optax's tx.update does;
    the caller adds them to the parameters."""

    def __init__(self, cfg: CAPEConfig, steps_per_epoch: int):
        if cfg.opt_state_dtype == "bfloat16":
            raise NotImplementedError(
                "opt_state_dtype=bfloat16 (bf16 momentum buffers) is not ported "
                "to cape_tpu_torch yet"
            )
        if cfg.opt_state_dtype not in ("float32", ""):
            raise ValueError(
                f"opt_state_dtype must be float32|bfloat16, got {cfg.opt_state_dtype!r}"
            )
        if cfg.optimizer not in ("sgd", "adam"):
            raise ValueError(f"optimizer must be sgd|adam, got {cfg.optimizer!r}")
        decay_steps = max(int(cfg.decay_every * steps_per_epoch), 1)
        warmup_steps = int(WARMUP_EPOCHS * decay_steps) if cfg.lr_warmup else 0
        self.sched = {
            "g": cape_schedule(cfg.lr, decay_steps, cfg.decay_rate, warmup_steps),
            "d": cape_schedule(cfg.lr * cfg.lr_scaler, decay_steps, cfg.decay_rate,
                               warmup_steps),
        }
        self.kind = cfg.optimizer
        self.momentum = cfg.momentum
        self.optim_condnet = cfg.optim_condnet
        self.count = {"g": 0, "d": 0}
        self.buffers: dict[str, dict[str, torch.Tensor]] = {}

    def labels(self, names) -> dict[str, str]:
        tops = param_labels(dict.fromkeys(n.split(".")[0] for n in names), self.optim_condnet)
        return {n: tops[n.split(".")[0]] for n in names}

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        labels = self.labels(grads)
        updates = {n: torch.zeros_like(g) for n, g in grads.items() if labels[n] == "frozen"}
        for player in ("g", "d"):
            names = [n for n in grads if labels[n] == player]
            if not names:
                continue
            norm = _global_norm(grads[n] for n in names)
            # optax: select(|g| < max, g, g / |g| * max), without a host sync
            clip = lambda g: torch.where(norm < GRAD_CLIP_NORM, g, g / norm * GRAD_CLIP_NORM)
            count = self.count[player]
            lr = float(self.sched[player](count))
            for n in names:
                g = clip(grads[n].float())
                buf = self.buffers.setdefault(n, {})
                if self.kind == "sgd":
                    trace = buf.get("trace")
                    buf["trace"] = g if trace is None else g + self.momentum * trace
                    direction = buf["trace"]
                else:
                    mu = buf.get("mu", torch.zeros_like(g))
                    nu = buf.get("nu", torch.zeros_like(g))
                    buf["mu"] = (1 - ADAM_B1) * g + ADAM_B1 * mu
                    buf["nu"] = (1 - ADAM_B2) * g.square() + ADAM_B2 * nu
                    c = np.float32(count + 1)
                    mu_hat = buf["mu"] / float(np.float32(1) - np.float32(ADAM_B1) ** c)
                    nu_hat = buf["nu"] / float(np.float32(1) - np.float32(ADAM_B2) ** c)
                    direction = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
                updates[n] = -lr * direction
            self.count[player] = count + 1
        return updates
