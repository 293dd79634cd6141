"""The traced stretch: a torch.profiler window over CPU and CUDA activity,
read back from its Chrome trace, and what the readers and the result's
`breakdown` take from it.

The profiler runs without stacks or shapes. Its trace is written under
the checkout (`common.WORK_DIR`), read, and deleted.
"""

from __future__ import annotations

import bisect
import collections
import json
import os

from bench_port import roofline
from bench_port.trace_attr import kernel_family

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("LaunchKernel", "GraphLaunch")


def profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def export(prof, path: str) -> None:
    """Write the profiler's Chrome trace to `path` (under the checkout)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def load(path: str) -> list[dict]:
    """A written trace's events; the file is removed."""
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def profile(fn, path: str, sync) -> list[dict]:
    """The trace events of fn() run under the profiler, the device
    synchronised by sync() before and after."""
    sync()
    with profiler() as prof:
        fn()
        sync()
    export(prof, path)
    return load(path)


def _xs(events):
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def device_events(events) -> list[dict]:
    return [e for e in _xs(events) if e.get("cat") in DEVICE_CATS]


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def window_us(events) -> tuple[float, float]:
    """The traced window: from the first event's start to the last's end."""
    xs = _xs(events)
    return min(e["ts"] for e in xs), max(e["ts"] + e.get("dur", 0) for e in xs)


def busy_us(events) -> float:
    """The union of the device's kernel and copy intervals."""
    return sum(b - a for a, b in _merged(
        (e["ts"], e["ts"] + e.get("dur", 0)) for e in device_events(events)))


def launches(events) -> int:
    """Host launch API calls (kernel and graph launches)."""
    return sum(1 for e in _xs(events) if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and any(s in e["name"] for s in LAUNCH_NAMES))


def kernel_us(events, fragments) -> tuple[float, int]:
    """(summed device time, count) of the kernels whose names hold one of
    `fragments`."""
    hits = [e for e in device_events(events) if e.get("cat") == "kernel"
            and any(f in e["name"] for f in fragments)]
    return sum(e.get("dur", 0) for e in hits), len(hits)


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time (by kernel family) and the
    longest idle time by the host operator running when each gap began,
    both in seconds over the traced window."""
    ops = collections.Counter()
    for e in device_events(events):
        ops[kernel_family(e["name"])] += e.get("dur", 0) / 1e6
    t0, t1 = window_us(events)
    busy = _merged((e["ts"], e["ts"] + e.get("dur", 0)) for e in device_events(events))
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    cpu = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in _xs(events)
                  if e.get("cat") == "cpu_op"), key=lambda c: c[0])
    starts = [c[0] for c in cpu]
    idle = collections.Counter()
    for a, b in gaps:
        # the innermost (latest-starting) operator open at the gap's start
        i = bisect.bisect_right(starts, a)
        label = "host, no operator"
        for s, e, name in reversed(cpu[max(0, i - 64): i]):
            if e > a:
                label = name
                break
        idle[label] += (b - a) / 1e6
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}


def launch_bounds(records) -> list[dict]:
    """The frozen `apply_bound` of each recorded band-apply launch
    (`program.LaunchRecorder`)."""
    return [roofline.apply_bound(blocks, B, rows_in, rows_out, C, dtype, addend)
            for blocks, _, rows_out, B, rows_in, C, dtype, addend in records]


def roofline_share(m: dict):
    """The mean bound of the recorded launches (`m["launch_bounds"]`) over
    the mean device time of a launch of the port's kernels in a profiled
    stretch (`m["trace_events"]`), in %. The records need not be the
    stretch's own: any whole number of the same steps or calls has the
    stretch's mean bound, and the trace holds a kernel's device time
    however it was launched (eagerly, or replayed from a CUDA graph).
    None without a port kernel in the stretch, or without a record."""
    from bench_port.trace_attr import PORT_KERNELS

    events, bounds = m.get("trace_events"), m.get("launch_bounds")
    if not events or not bounds:
        return None
    us, n = kernel_us(events, PORT_KERNELS)
    if not n:
        return None
    bound_ms = sum(b["bound_ms"] for b in bounds) / len(bounds)
    return 100.0 * bound_ms / (us / 1000.0 / n)


def device_fields(events) -> dict:
    """busy_s and window_s of the traced window, for the result's device."""
    t0, t1 = window_us(events)
    return {"busy_s": busy_us(events) / 1e6, "window_s": (t1 - t0) / 1e6}
