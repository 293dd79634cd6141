"""band_kernel_launches.train: launches of the port's band-gather kernel
(`band_gather_kernel`, csrc/band_gather.cu) per train step in the profiled
stretch, from the device trace: an exact count of the kernel routes' band
applies, the conv route's and the plain BandedOp applies' together. Lower
is better, as for host_launches.train: the same applies in fewer launches.
A fall beside a rise of host_launches.train means applies left the kernel.
None where the stretch has no device events."""

from bench_port import tracing


def read(m: dict):
    events = m.get("trace_events")
    if not events or not m.get("profiled_steps") or not tracing.device_events(events):
        return None
    return tracing.kernel_us(events, ("band_gather_kernel",))[1] / m["profiled_steps"]
