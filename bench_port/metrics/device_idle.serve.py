"""device_idle.serve: the share of the profiled serving stretch in which no
kernel or copy ran on the device, from one timeline: 1 - (union of the
device's intervals) / (the traced window), in %."""

from bench_port import tracing


def read(m: dict):
    if not m.get("trace_events") or not tracing.device_events(m["trace_events"]):
        return None
    f = tracing.device_fields(m["trace_events"])
    return 100.0 * (1.0 - f["busy_s"] / f["window_s"])
