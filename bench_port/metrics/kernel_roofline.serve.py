"""kernel_roofline.serve: the port's band-gather kernel in the profiled
serving stretch, as the frozen `apply_bound` of each launch's recorded
shapes over its device time, summed, in %. None where the stretch
launched no port kernel."""

from bench_port import tracing


def read(m: dict):
    return tracing.roofline_share(m)
