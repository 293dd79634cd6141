"""encode_launches.train: host launch API calls (kernel and graph
launches, as host_launches.train counts them) that start inside the
program's `model.encode` span (`CAPE.encode`) on the thread that drives
the steps, per profiled train step: an exact count. The encoder's forward
only: its backward runs on autograd's thread, as train.backward's does,
outside the span. None where the stretch has no device events or no such
span (a program without it)."""

from bench_port import model_spans


def read(m: dict):
    return model_spans.launches_per_step(m, "model.encode")
