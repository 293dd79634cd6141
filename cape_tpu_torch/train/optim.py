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

opt_state_dtype=bfloat16 stores SGD's trace or Adam's mu in bf16 (Adam's nu
stays f32), rounding where optax's op-by-op update rounds: the stored
moment times the decay (itself rounded to bf16) is a bf16 product, added
to the f32 gradient term; the update is computed from that f32 sum, and
the sum is cast to bf16 for storage. (Under jit, XLA on the CPU keeps that
product in f32: one bf16 rounding of the decayed moment apart.)

`state_arrays` and `load_state_arrays` carry the state under the JAX
package's keypaths of a train state's `.opt_state`, so that a checkpoint
of either package resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from cape_tpu_torch.core.bridge import jax_keypath
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


def _rounded(x: float, dtype: torch.dtype) -> float:
    """x as `dtype` holds it: optax multiplies a moment by its decay in the
    moment's dtype."""
    return float(torch.tensor(x, dtype=dtype))


class Optimizer:
    """Both players' optimizer state (update counts and moment buffers, in
    cfg.opt_state_dtype but Adam's nu, which is f32) and its update.
    update() maps gradients keyed by dotted parameter path
    (`discriminator.layer0.w`) to f32 updates, as optax's tx.update does;
    the caller adds them to the parameters."""

    def __init__(self, cfg: CAPEConfig, steps_per_epoch: int):
        if cfg.opt_state_dtype not in ("float32", "bfloat16", ""):
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
        self.state_dtype = torch.bfloat16 if cfg.opt_state_dtype == "bfloat16" else torch.float32
        # the decay of the stored moment (SGD's trace, Adam's mu)
        self.decay = _rounded(cfg.momentum if self.kind == "sgd" else ADAM_B1, self.state_dtype)
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
                    direction = g if trace is None else g + trace * self.decay
                    buf["trace"] = direction.to(self.state_dtype)
                else:
                    mu = buf.get("mu", torch.zeros_like(g, dtype=self.state_dtype))
                    nu = buf.get("nu", torch.zeros_like(g))
                    mu = (1 - ADAM_B1) * g + mu * self.decay
                    nu = (1 - ADAM_B2) * g.square() + ADAM_B2 * nu
                    buf["mu"], buf["nu"] = mu.to(self.state_dtype), nu
                    c = np.float32(count + 1)
                    mu_hat = mu / float(np.float32(1) - np.float32(ADAM_B1) ** c)
                    nu_hat = nu / float(np.float32(1) - np.float32(ADAM_B2) ** c)
                    direction = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
                updates[n] = -lr * direction
            self.count[player] = count + 1
        return updates

    def _slots(self) -> tuple[str, ...]:
        return ("trace",) if self.kind == "sgd" else ("mu", "nu")

    def state_arrays(self, params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """The state as the JAX package's train state holds it, keyed by its
        keypaths (`.opt_state.inner_states['g'].inner_state[1][0].trace[...]`,
        `...inner_state[1][1].count`; Adam's `[1][0]` holds count, mu and
        nu), moments as f32 arrays. `params`: the parameters by dotted path,
        which give each moment's shape; a moment never written is zeros, as
        optax initialises it."""
        labels = self.labels(params)
        out = {}
        for player in ("g", "d"):
            head = f".opt_state.inner_states['{player}'].inner_state[1]"
            count = np.asarray(self.count[player], np.int32)
            out[f"{head}[1].count"] = count
            if self.kind == "adam":
                out[f"{head}[0].count"] = count
            for n in sorted(k for k in params if labels[k] == player):
                for slot in self._slots():
                    t = self.buffers.get(n, {}).get(slot)
                    out[f"{head}[0].{slot}{jax_keypath(n)}"] = (
                        np.zeros(tuple(params[n].shape), np.float32) if t is None
                        else t.detach().float().cpu().numpy())
        return out

    def load_state_arrays(self, arrays: dict[str, np.ndarray],
                          params: dict[str, torch.Tensor]) -> None:
        """Take the state from `arrays` keyed as `state_arrays` writes them
        (a checkpoint of either package), onto each parameter's device, in
        the state dtype. The update count is the schedule's, `[1][1].count`."""
        labels = self.labels(params)
        self.buffers = {}
        for player in ("g", "d"):
            head = f".opt_state.inner_states['{player}'].inner_state[1]"
            self.count[player] = int(arrays[f"{head}[1].count"])
            for n in (k for k in params if labels[k] == player):
                p = params[n]
                self.buffers[n] = {
                    slot: torch.from_numpy(np.asarray(
                        arrays[f"{head}[0].{slot}{jax_keypath(n)}"], np.float32))
                    .reshape(p.shape).to(p.device,
                                         torch.float32 if slot == "nu" else self.state_dtype)
                    for slot in self._slots()
                }
