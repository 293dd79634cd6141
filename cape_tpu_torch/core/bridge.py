"""Parameter bridge between the JAX package's pytrees and this package.

The JAX model keeps its parameters in a nested dict whose key paths
(`['generator']['decoder']['layer0']['conv']['w']`) are also its
checkpoint keys (`cape_tpu.train.checkpoint.flatten_tree`, `jax.tree_util.
keystr`). Here the same paths are module paths of `CAPE`
(`generator.decoder.layer0.conv.w`), so a state dict and a JAX tree map one
to one, with no renaming table. Everything here is numpy and torch: a
JAX-written checkpoint is read without JAX.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_KEYSTR_PART = re.compile(r"\['([^']*)'\]")


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = np.asarray(v)
    return out


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a JAX param tree after device_get) ->
    state dict with dotted module paths."""
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in _flatten(tree).items()}


def to_jax_params(module: nn.Module) -> dict:
    """Module parameters -> nested dict of numpy arrays in the JAX layout."""
    tree: dict = {}
    for path, t in module.state_dict().items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    return tree


def load_jax_checkpoint(npz_path: str) -> dict[str, torch.Tensor]:
    """State dict of the model parameters in a JAX-written checkpoint.

    Checkpoints of a train state hold `.params[...]`, `.opt_state...` and
    `.step` keys; only the parameters are taken. A checkpoint of a bare
    param tree (keys starting with `[`) is taken whole."""
    sd = {}
    with np.load(npz_path, allow_pickle=False) as data:
        keys = list(data.keys())
        prefix = ".params" if any(k.startswith(".params[") for k in keys) else ""
        for key in keys:
            if not key.startswith(prefix + "["):
                continue
            rest = key[len(prefix):]
            parts = _KEYSTR_PART.findall(rest)
            if "".join(f"['{p}']" for p in parts) != rest:
                raise ValueError(f"unexpected checkpoint key {key!r}")
            sd[".".join(parts)] = torch.from_numpy(np.array(data[key], copy=True))
    if not sd:
        raise ValueError(f"{npz_path} holds no parameter keys")
    return sd
