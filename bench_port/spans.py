"""The program's phase spans in a profiled train stretch, and the device's
idle time and the host's launches inside them.

`Trainer.run_steps` names its phases with `record_function` spans while a
profiler runs (`cape_tpu_torch.train.metrics.TRAIN_SPANS`). They reach the
Chrome trace as `user_annotation` events on the thread that called
`run_steps`, on the one timeline of the kernels and the launches. A
program without the spans (an older checkout) gives no such event, and
every reader of this module then returns None.
"""

from __future__ import annotations

import bisect
import collections

from bench_port import tracing

# The span names the readers look for, frozen here as a part of the
# yardstick; the CPU tests hold them equal to the program's.
TRAIN_SPANS = ("train.noise", "train.step", "train.gather", "train.forward", "train.backward",
               "train.reduce", "train.optimizer", "train.screen")


def _thread_spans(events) -> tuple[tuple | None, dict[str, list[tuple[float, float]]]]:
    """((pid, tid) of the thread that holds the train.step spans, {name:
    [(start, end), ...]} of the TRAIN_SPANS events on it, in µs); (None,
    {}) where the trace has no train.step span."""
    ann = [e for e in tracing._xs(events)
           if e.get("cat") == "user_annotation" and e.get("name") in TRAIN_SPANS]
    steps = collections.Counter((e.get("pid"), e.get("tid")) for e in ann if e["name"] == "train.step")
    if not steps:
        return None, {}
    thread = steps.most_common(1)[0][0]
    out: dict[str, list[tuple[float, float]]] = {}
    for e in ann:
        if (e.get("pid"), e.get("tid")) == thread:
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e.get("dur", 0)))
    return thread, out


def spans(events) -> dict[str, list[tuple[float, float]]]:
    """{name: [(start, end), ...]} of the spans on the train.step thread."""
    return _thread_spans(events)[1]


def idle_intervals(events) -> list[tuple[float, float]]:
    """The traced window less the union of the device's kernel and copy
    intervals: the time `device_idle.train` counts as idle."""
    t0, t1 = tracing.window_us(events)
    busy = tracing._merged((e["ts"], e["ts"] + e.get("dur", 0))
                           for e in tracing.device_events(events))
    out, at = [], t0
    for a, b in busy:
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out


def _overlap_us(xs, ys) -> float:
    """The length of the intersection of two unions of intervals."""
    xs, ys = tracing._merged(xs), tracing._merged(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(m: dict, name: str):
    """The share of the traced window in which the device was idle while
    the train.step thread was inside a `name` span, in %. None without
    device events or without such a span."""
    events = m.get("trace_events")
    if not events or not tracing.device_events(events):
        return None
    within = spans(events).get(name)
    if not within:
        return None
    t0, t1 = tracing.window_us(events)
    return 100.0 * _overlap_us(idle_intervals(events), within) / (t1 - t0)


def launches_per_step(m: dict, name: str):
    """Kernel and graph launch API calls (as `tracing.launches` counts
    them) that start inside a `name` span on the train.step thread, per
    profiled step. None without device events, steps or such a span."""
    events = m.get("trace_events")
    if not events or not m.get("profiled_steps") or not tracing.device_events(events):
        return None
    thread, by_name = _thread_spans(events)
    within = tracing._merged(by_name.get(name, []))
    if not within:
        return None
    starts = [a for a, _ in within]

    def inside(e) -> bool:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        return i >= 0 and e["ts"] < within[i][1]

    mine = [e for e in tracing._xs(events)
            if (e.get("pid"), e.get("tid")) == thread and inside(e)]
    return tracing.launches(mine) / m["profiled_steps"]
