"""The model's spans in a profiled train stretch, and the device's idle
time and the host's launches inside them.

`CAPE.encode` names its forward `model.encode` while a profiler runs
(`cape_tpu_torch.train.metrics.MODEL_SPANS`). In a train step it runs on
the thread that drives the steps, inside `train.forward`; its backward
runs on autograd's thread, outside the span. That thread is the one
`spans.py` finds (the one that holds `train.step`). A program without the
span (an older checkout) gives no such event, and every reader of this
module then returns None.
"""

from __future__ import annotations

import bisect

from bench_port import spans, tracing

# The span names the readers look for, frozen here as a part of the
# yardstick; the CPU tests hold them equal to the program's.
MODEL_SPANS = ("model.encode",)


def _thread_spans(events) -> tuple[tuple | None, dict[str, list[tuple[float, float]]]]:
    """((pid, tid) of the thread that holds the train.step spans, {name:
    [(start, end), ...]} of the MODEL_SPANS events on it, in µs); (None,
    {}) where the trace has no train.step span."""
    thread = spans._thread_spans(events)[0]
    out: dict[str, list[tuple[float, float]]] = {}
    if thread is None:
        return None, out
    for e in tracing._xs(events):
        if (e.get("cat") == "user_annotation" and e.get("name") in MODEL_SPANS
                and (e.get("pid"), e.get("tid")) == thread):
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e.get("dur", 0)))
    return thread, out


def model_spans(events) -> dict[str, list[tuple[float, float]]]:
    """{name: [(start, end), ...]} of the model's spans on the train.step
    thread."""
    return _thread_spans(events)[1]


def idle_share(m: dict, name: str):
    """The share of the traced window in which the device was idle while
    the train.step thread was inside a `name` span, in %. None without
    device events or without such a span."""
    events = m.get("trace_events")
    if not events or not tracing.device_events(events):
        return None
    within = model_spans(events).get(name)
    if not within:
        return None
    t0, t1 = tracing.window_us(events)
    return 100.0 * spans._overlap_us(spans.idle_intervals(events), within) / (t1 - t0)


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
