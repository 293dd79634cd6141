"""Hand-written kernels for Hopper and their plain PyTorch versions, and the
routing override of the JAX package.

A wrapper here takes its plain version only for tensors on the CPU or the
`meta` device; for a CUDA tensor it launches its kernel or raises.

`CAPE_TPU_PALLAS` is the JAX package's documented kill switch
(`cape_tpu/ops/pallas/__init__.py`), read live at every routing decision in
`ops.cheb.cheb_conv`, so both packages route the same convs under the same
environment:

  * "0" turns every kernel route off, whatever the config says;
  * "1" turns the kernel routes on even where `use_pallas=False`, and opts
    into the small-batch v2 route (`enabled()`);
  * unset (or any other value) follows the config.

It decides routes only. It is not a fallback: no wrapper reads it, and a
wrapper given a CUDA tensor launches its kernel or raises.
"""

from __future__ import annotations

import os

_enabled = False  # set_enabled(True): opt into the small-batch v2 route from code


def override() -> bool | None:
    """The live CAPE_TPU_PALLAS setting: False ("0"), True ("1"), or None
    (unset or anything else: follow each op's config)."""
    v = os.environ.get("CAPE_TPU_PALLAS")
    if v == "0":
        return False
    if v == "1":
        return True
    return None


def enabled() -> bool:
    """Opt-in gate of the small-batch v2 route."""
    return _enabled or override() is True


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)
