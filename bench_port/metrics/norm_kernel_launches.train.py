"""norm_kernel_launches.train: launches of the port's fused group norm +
ReLU kernels (`group_norm_relu_*`, csrc/group_norm_relu.cu: one forward,
two backward a norm) per train step in the profiled stretch, from the
device trace: an exact count of the GraphCMR decoder's norms that took the
kernel. 0 where the step runs none (the affine decoder) or the program has
no such kernel; None where the stretch has no device events."""

from bench_port import tracing

# the fragment every one of the kernels' names holds
NORM_KERNEL = "group_norm_relu_"


def read(m: dict):
    events = m.get("trace_events")
    if not events or not m.get("profiled_steps") or not tracing.device_events(events):
        return None
    return tracing.kernel_us(events, (NORM_KERNEL,))[1] / m["profiled_steps"]
