"""Checkpoints of a training run, readable by both packages' restore paths.

Counterpart of `cape_tpu.train.checkpoint`: one `ckpt_<step:010d>.npz` per
save, written atomically (tmp file + rename) and pruned to the newest
`keep`, holding the whole train state under the JAX package's keypath
strings: `.params['generator']['decoder']['fc1']['kernel']`, the optimizer
state (`.opt_state.inner_states['g'].inner_state[1][0].trace[...]`, see
`Optimizer.state_arrays`) and `.step`. bf16 leaves are stored as f32
(exact), as the JAX package stores them. So the JAX package's
`restore_latest` resumes a run trained here, `restore_latest` here resumes
one trained there, and `core.bridge.load_jax_checkpoint` (the server's and
`apps.main.restore_params`' reader) takes the parameters of either.
"""

from __future__ import annotations

import os
import re
import warnings
import zipfile

import numpy as np
import torch
from torch import nn

from cape_tpu_torch.core.bridge import jax_keypath

_CKPT = re.compile(r"ckpt_\d+\.npz")
_TMP = re.compile(r"\.tmp_ckpt_\d+\.npz")


class CheckpointMismatchError(ValueError):
    """The checkpoint file is intact but does not fit the train state: a key
    is missing or a leaf has another number of elements. It was written by
    another model or optimizer configuration; `restore_latest` never falls
    back past it to an older file, which would hide the mistake."""


def flatten_params(model: nn.Module) -> dict[str, np.ndarray]:
    """{".params['a']['b']": f32 array} over the model's state dict."""
    return {
        ".params" + jax_keypath(path): t.detach().float().cpu().numpy()
        for path, t in model.state_dict().items()
    }


def flatten_state(state) -> dict[str, np.ndarray]:
    """A train state (`train.step.TrainState`) as {keypath: array}: its
    parameters, its optimizer's state and its step."""
    return {
        **flatten_params(state.model),
        **state.tx.state_arrays(dict(state.model.named_parameters())),
        ".step": np.asarray(state.step, np.int32),
    }


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 5) -> str:
    """Write `state` (a TrainState) at `step`, pruning to the newest `keep`
    files; stale tmp files of writers that died mid-save are swept first."""
    os.makedirs(ckpt_dir, exist_ok=True)
    for stale in os.listdir(ckpt_dir):
        if _TMP.fullmatch(stale):
            os.remove(os.path.join(ckpt_dir, stale))
    flat = flatten_state(state)
    path = os.path.join(ckpt_dir, f"ckpt_{step:010d}.npz")
    tmp = os.path.join(ckpt_dir, f".tmp_ckpt_{step:010d}.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    if keep > 0:
        for old in sorted(f for f in os.listdir(ckpt_dir) if _CKPT.fullmatch(f))[:-keep]:
            os.remove(os.path.join(ckpt_dir, old))
    return path


def checked(flat: dict[str, np.ndarray], template: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The leaves of `flat` for every key of `template`, each cast to the
    template's dtype and reshaped to its shape (a TF-converted checkpoint
    may hold a (1, 1, F) bias for an (F,) one). A missing key or another
    element count raises CheckpointMismatchError naming the key."""
    out = {}
    for key, ref in template.items():
        if key not in flat:
            raise CheckpointMismatchError(
                f"checkpoint missing key {key!r}: it was written by a different "
                f"model/optimizer configuration ({len(flat)} keys present)"
            )
        got = np.asarray(flat[key])
        if got.size != ref.size:
            raise CheckpointMismatchError(
                f"checkpoint leaf {key!r} has shape {got.shape} but the train state "
                f"expects {ref.shape}: wrong config for this checkpoint"
            )
        out[key] = got.astype(ref.dtype).reshape(ref.shape)
    return out


def load_state(state, flat: dict[str, np.ndarray]) -> None:
    """Put the checkpoint leaves `flat` into `state` in place: parameters,
    optimizer state and step. Every leaf is checked (`checked`) before any
    is taken."""
    leaves = checked(flat, flatten_state(state))
    model = state.model
    with torch.no_grad():
        for path, p in model.state_dict().items():
            p.copy_(torch.from_numpy(leaves[".params" + jax_keypath(path)]))
    state.tx.load_state_arrays(leaves, dict(model.named_parameters()))
    state.step = int(leaves[".step"])


def restore_latest(ckpt_dir: str, state) -> str | None:
    """Restore the newest readable checkpoint into `state`, falling back
    past corrupt or truncated files with a RuntimeWarning. Returns its path,
    or None (state untouched) when no checkpoint is readable. A
    CheckpointMismatchError (an intact file of another configuration)
    propagates."""
    if not os.path.isdir(ckpt_dir):
        return None
    for fname in sorted((f for f in os.listdir(ckpt_dir) if _CKPT.fullmatch(f)), reverse=True):
        path = os.path.join(ckpt_dir, fname)
        try:
            with np.load(path, allow_pickle=False) as data:
                flat = dict(data)
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as exc:
            warnings.warn(
                f"checkpoint {path} is unreadable ({type(exc).__name__}: {exc}): "
                "falling back to the previous checkpoint",
                RuntimeWarning, stacklevel=2,
            )
            continue
        load_state(state, flat)
        return path
    return None


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(f for f in os.listdir(ckpt_dir) if _CKPT.fullmatch(f))
    return os.path.join(ckpt_dir, names[-1]) if names else None
