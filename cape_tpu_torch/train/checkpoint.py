"""Checkpoints of a training run, readable by both packages' restore paths.

One `ckpt_<step:010d>.npz` per save, written atomically (tmp file +
rename) and pruned to the newest `keep`. Keys are the JAX package's keypath
strings of a train state: `.params['generator']['decoder']['fc1']['kernel']`
and `.step`, so `core.bridge.load_jax_checkpoint` (and through it
`apps.main.restore_params` and the server) reads a run trained here. The
optimizer state is not written yet, so a run cannot resume from it.
"""

from __future__ import annotations

import os
import re

import numpy as np
from torch import nn

_CKPT = re.compile(r"ckpt_\d+\.npz")
_TMP = re.compile(r"\.tmp_ckpt_\d+\.npz")


def flatten_params(model: nn.Module) -> dict[str, np.ndarray]:
    """{".params['a']['b']": f32 array} over the model's state dict."""
    return {
        ".params" + "".join(f"['{p}']" for p in path.split(".")): t.detach().float().cpu().numpy()
        for path, t in model.state_dict().items()
    }


def save_checkpoint(ckpt_dir: str, model: nn.Module, step: int, keep: int = 5) -> str:
    """Write the parameters at `step`, pruning to the newest `keep` files;
    stale tmp files of writers that died mid-save are swept first."""
    os.makedirs(ckpt_dir, exist_ok=True)
    for stale in os.listdir(ckpt_dir):
        if _TMP.fullmatch(stale):
            os.remove(os.path.join(ckpt_dir, stale))
    path = os.path.join(ckpt_dir, f"ckpt_{step:010d}.npz")
    tmp = os.path.join(ckpt_dir, f".tmp_ckpt_{step:010d}.npz")
    np.savez(tmp, **flatten_params(model), **{".step": np.asarray(step, np.int32)})
    os.replace(tmp, path)
    if keep > 0:
        for old in sorted(f for f in os.listdir(ckpt_dir) if _CKPT.fullmatch(f))[:-keep]:
            os.remove(os.path.join(ckpt_dir, old))
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(f for f in os.listdir(ckpt_dir) if _CKPT.fullmatch(f))
    return os.path.join(ckpt_dir, names[-1]) if names else None
