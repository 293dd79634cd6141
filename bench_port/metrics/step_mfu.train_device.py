"""step_mfu.train_device: the operations one train step needs
(`flops.Counter.train_step`) over the device's busy time a step in the
profiled stretch (the union of its kernel and copy intervals, as
train_device_ms_per_step takes it), as a share of the card's peak in the
compute dtype (`roofline.PEAK_FLOP_PER_S`), in %. None where the stretch
has no device events."""

from bench_port import tracing


def read(m: dict):
    events = m.get("trace_events")
    if "step_ops" not in m or not events or not tracing.device_events(events):
        return None
    busy_s = tracing.busy_us(events) / 1e6 / m["profiled_steps"]
    return 100.0 * m["step_ops"] / busy_s / m["peak_flops"]
