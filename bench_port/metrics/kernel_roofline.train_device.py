"""kernel_roofline.train_device: kernel_roofline.train's reading (the mean
frozen `apply_bound` of the band applies recorded over the set-up's steps
over the mean device time of a port-kernel launch in the profiled
stretch, in %), for the train cells whose end-to-end metric besides
setup_s is the device's time a step. None where the stretch launched no
port kernel or the set-up recorded no apply."""

from bench_port import tracing


def read(m: dict):
    return tracing.roofline_share(m)
