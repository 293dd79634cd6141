"""The reader of norm_kernel_launches.train on hand-built Chrome traces:
the port's fused group norm + ReLU kernels counted per step, every other
kernel left out."""

import pytest

from bench_port import common
from bench_port.tests.test_bench_spans import _kernel, _trace

NAME = "norm_kernel_launches.train"
# the kernels of csrc/group_norm_relu.cu as the profiler names them
NORM_KERNELS = (
    "void (anonymous namespace)::group_norm_relu_fwd_kernel<float, 4, true>"
    "(float const*, float const*, float const*, float*, float*, float*, "
    "(anonymous namespace)::Cut, float)",
    "void (anonymous namespace)::group_norm_relu_bwd_kernel<float, 4, true>(float const*, ...)",
    "(anonymous namespace)::group_norm_relu_dparam_kernel(float const*, float*, float*, int, int)",
)
# what the plain version launches in their place (the parent's trace)
PLAIN_KERNELS = (
    "void at::native::elementwise_kernel<128, 2, ...>",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, ...> >",
    "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
    "threshold_kernel_impl<float>(...)>",
    "band_gather_kernel<float, 4, 12>",
)


def _read(m):
    return common.reader(NAME).read(m)


def _kernels(names, per_step):
    """Each kernel of `names` launched `per_step` times in each of
    _trace()'s two steps."""
    ev = []
    for s in (100, 200):
        for i in range(per_step):
            for name in names:
                ev.append({**_kernel(s + 41 + i, s + 41.5 + i), "name": name})
    return ev


def test_counts_the_norm_kernels_a_step():
    """24 norms a step, one forward and two backward launches each: 72 a
    step, the plain operators' and the band kernel's launches beside them
    not counted."""
    ev = _trace() + _kernels(NORM_KERNELS, 24) + _kernels(PLAIN_KERNELS, 5)
    assert _read({"trace_events": ev, "profiled_steps": 2}) == 72.0


@pytest.mark.parametrize("names", [(), PLAIN_KERNELS], ids=["no kernel", "the parent's"])
def test_zero_without_the_kernel(names):
    """A stretch with device events but no norm kernel reads 0: the affine
    decoder's step, or a program without the kernel, whose plain version
    launches PyTorch's own elementwise and reduction kernels."""
    assert _read({"trace_events": _trace() + _kernels(names, 19), "profiled_steps": 2}) == 0.0


def test_none_without_device_events():
    ev = _trace() + _kernels(NORM_KERNELS, 3)
    host_only = [e for e in ev if e["cat"] not in ("kernel", "gpu_memcpy")]
    assert _read({"trace_events": host_only, "profiled_steps": 2}) is None
    assert _read({"trace_events": ev, "profiled_steps": 0}) is None
    assert _read({}) is None
