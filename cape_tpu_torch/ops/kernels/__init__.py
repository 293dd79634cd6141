"""Hand-written kernels for Hopper and their plain PyTorch versions: the
seam every kernel wrapper goes through, and the routing override of the
JAX package.

A wrapper here takes its plain version only for tensors on the CPU or the
`meta` device; for a CUDA tensor it launches its kernel or raises. What a
wrapper takes from this module, and nothing else of another wrapper's:

  * the launch plumbing: `DTYPE_CODES`, the dtype code each kernel of
    `csrc/` reads (a kernel may take fewer dtypes); `SMEM_MAX`; `stream`,
    the stream to launch on; `check_cuda` / `check_tensors`, what every
    wrapper checks before a launch; `raise_on`, the raise on a failed one;
  * the route predicate `allowed`, for an op that may take a kernel;
  * `counts`, one `collections.Counter` of every kernel launch, by key:

      band_apply.conv / band_apply.conv_bwd   the conv route's band applies
                                              (cheb2_banded_v3 / _v2 forward,
                                              cheb2_banded_v3 backward)
      band_apply.op                           the plain BandedOp applies on
                                              the band-gather kernel
      band_apply.bfloat16 / .float16          every band_apply launch on
                                              bf16 / f16 tensors
      band_apply_bm                           banded_apply_bm
      cheb2_fused.g1 / cheb2_fused            fused_cheb2, a group of 1 / more
      cheb2_window.t1 / cheb2_window.t2       ring_cheb2, 1 / 2 row tiles
      group_norm_relu                         ops.norm: 1 forward, 2 backward
      route.v3 / route.v2                     convs the gate of ops.cheb sent
                                              to the v3 / v2 route (CPU and
                                              meta calls too)

    CPU and `meta` tensors count no launch. The Counter is one object for
    good: clear it in place (`counts.clear()`), never rebind it.

`CAPE_TPU_PALLAS` is the JAX package's documented kill switch
(`cape_tpu/ops/pallas/__init__.py`), read live at every routing decision
(`allowed`), so both packages route the same convs under the same
environment:

  * "0" turns every kernel route off, whatever the config says;
  * "1" turns the kernel routes on even where `use_pallas=False`, and opts
    into the small-batch v2 route (`enabled()`);
  * unset (or any other value) follows the config.

It decides routes only. It is not a fallback: no wrapper reads it, and a
wrapper given a CUDA tensor launches its kernel or raises.
"""

from __future__ import annotations

import collections
import os

import torch

_enabled = False  # set_enabled(True): opt into the small-batch v2 route from code

counts: collections.Counter = collections.Counter()

# the dtype codes of the kernels of csrc/; the fused and windowed conv
# kernels (csrc/cheb2_fused.cu) take the first two only
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SMEM_MAX = 232448   # bytes of shared memory an H100 block may have


def override() -> bool | None:
    """The live CAPE_TPU_PALLAS setting: False ("0"), True ("1"), or None
    (unset or anything else: follow each op's config)."""
    v = os.environ.get("CAPE_TPU_PALLAS")
    if v == "0":
        return False
    if v == "1":
        return True
    return None


def allowed(op_allows: bool) -> bool:
    """Whether an op may take a kernel route: the live CAPE_TPU_PALLAS
    override where it is set, else the op's own `allow_pallas`."""
    env = override()
    return op_allows if env is None else env


def enabled() -> bool:
    """Opt-in gate of the small-batch v2 route."""
    return _enabled or override() is True


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def stream(x: torch.Tensor) -> int:
    """The current CUDA stream of x's device, as a launch takes it."""
    return torch.cuda.current_stream(x.device).cuda_stream


def check_cuda(name: str, x: torch.Tensor, dtypes=DTYPE_CODES,
               **others: torch.Tensor | None) -> None:
    """What every kernel wrapper checks before a launch: x is a CUDA tensor,
    and `check_tensors` holds."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    check_tensors(name, x, dtypes, **others)


def check_tensors(name: str, x: torch.Tensor, dtypes=DTYPE_CODES,
                  **others: torch.Tensor | None) -> None:
    """x is contiguous and of a dtype in `dtypes` (the kernel's), and each
    other tensor given (not None) is contiguous, of x's dtype and on x's
    device."""
    if x.dtype not in dtypes:
        names = ", ".join(_name(d) for d in dtypes)
        raise TypeError(f"{name}: dtype {x.dtype} (kernel takes {names})")
    for k, t in {"x": x, **others}.items():
        if t is None:
            continue
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name}: {k} {t.dtype} on {t.device}, x {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def raise_on(name: str, lib, err: int, shapes) -> None:
    """Raise on a failed launch; `shapes()` describes it (formatted only then,
    off the launch's host path)."""
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.cape_cuda_error_string(err).decode()} ({shapes()})"
        )
