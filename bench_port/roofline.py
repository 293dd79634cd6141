"""The yardstick of a kernel's roofline share: the H100's published peaks
and the least time a call could take.

Frozen copy of `chip_smoke.py` lines 353-510 as they stood when the
benchmark was written (`HBM_BYTES_PER_S`, `PEAK_FLOP_PER_S`, `bound`,
`apply_bound`, `conv_bound`, `summed_bound`), unchanged but for this
docstring, so that a later change to the program or to `chip_smoke.py`
cannot move the benchmark's bounds.
"""

from __future__ import annotations

import torch

# the H100 SXM's published peaks at its full 700 W (NVIDIA's data sheet):
# device memory, and per input dtype f32 outside the tensor cores and dense
# bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time the card could take for a call: the larger of the
    bytes it must move over the memory rate and its operations over the peak
    rate for its dtype (`HBM_BYTES_PER_S`, `PEAK_FLOP_PER_S`); which of the
    two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[_name(dtype)] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nnz(blocks) -> int:
    return int((blocks != 0).sum().item())


def apply_bound(blocks, B: int, rows_in: int, rows_out: int, C: int, dtype, addend=False) -> dict:
    """`bound` of a band apply y = M x (+ r): x read once, y written once (r
    read once), the band as its non-zero values with a 4-byte column index
    each; 2 operations per non-zero entry, sample and channel (and one add
    per element of r). `bytes` is that byte count."""
    el = torch.empty((), dtype=dtype).element_size()
    rows = rows_in + rows_out * (2 if addend else 1)
    nnz = _nnz(blocks)
    nbytes = el * B * C * rows + nnz * (el + 4)
    return {**bound(nbytes, 2 * nnz * B * C + (B * rows_out * C if addend else 0), dtype),
            "bytes": nbytes}


def conv_bound(blocks, B: int, rows_in: int, rows_out: int, C: int, F: int, dtype) -> dict:
    """`bound` of the fused K=2 conv: x read once, y written once, w0 and w1
    and the band (as in apply_bound) read once; the band sum (2 per non-zero
    entry, sample and channel) and both projections (4 C F per output row
    and sample)."""
    el = torch.empty((), dtype=dtype).element_size()
    nnz = _nnz(blocks)
    return bound(el * (B * rows_in * C + B * rows_out * F + 2 * C * F) + nnz * (el + 4),
                 2 * nnz * B * C + 4 * B * rows_out * C * F, dtype)


def summed_bound(records, weight=lambda r: 1) -> dict:
    """The bounds of several calls summed, set by what sets most of the sum."""
    by = {"bytes": 0.0, "operations": 0.0}
    for r in records:
        by[r["bound_by"]] += weight(r) * r["bound_ms"]
    return {"bound_ms": sum(by.values()), "bound_by": max(by, key=by.get)}
