"""kernel_roofline.train: the port's band-gather kernel in the profiled
train stretch, as the mean frozen `apply_bound` of the band applies
recorded over the set-up's steps (every step makes the same) over the mean
device time of a port-kernel launch in the stretch, in %. None where the
stretch launched no port kernel (a batch the routing gate keeps off the
kernel) or the set-up recorded no apply."""

from bench_port import tracing


def read(m: dict):
    return tracing.roofline_share(m)
