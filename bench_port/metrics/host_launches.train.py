"""host_launches.train: host launch API calls (kernel and graph launches)
per train step in the profiled stretch, from the profiler's runtime
events: an exact count."""

from bench_port import tracing


def read(m: dict):
    events = m.get("trace_events")
    if not events or not m.get("profiled_steps") or not tracing.device_events(events):
        return None
    return tracing.launches(m["trace_events"]) / m["profiled_steps"]
