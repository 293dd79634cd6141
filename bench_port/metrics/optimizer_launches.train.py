"""optimizer_launches.train: host launch API calls (kernel and graph
launches, as host_launches.train counts them) that start inside the
program's `train.optimizer` span on the same thread, per profiled train
step: an exact count. None where the stretch has no device events or no
such span (a program without spans)."""

from bench_port import spans


def read(m: dict):
    return spans.launches_per_step(m, "train.optimizer")
