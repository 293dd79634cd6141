"""idle_encode.train: the share of the profiled train stretch in which no
kernel or copy ran on the device while the thread that drives the steps
was inside the program's `model.encode` span (`CAPE.encode`'s forward,
inside train.forward): the device's idle intervals, as device_idle.train
takes them, intersected with the span's intervals, over the traced
window, in %. None where the stretch has no device events or no such
span (a program without it)."""

from bench_port import model_spans


def read(m: dict):
    return model_spans.idle_share(m, "model.encode")
