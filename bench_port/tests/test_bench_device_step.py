"""The train cells' device time a step (`train_device_ms_per_step`, an
end-to-end metric read from a profiled stretch after the window, also
with --trace 0) and the readers that move it: by hand on built traces,
and a whole toy run on the CPU with the stretch's trace stood in for."""

import math

import pytest
import torch

from bench_port import common, program, tracing, train_cell
from bench_port.tests import toy

torch.set_num_threads(2)

BAND = "void band_gather_kernel<float>(float const*, int const*, float const*, float*, int)"
OTHER = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >()"


def _x(name, ts, dur, cat, tid=7):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def _trace() -> list[dict]:
    """Two steps: a band kernel 0-30 µs overlapping a copy 20-50, an
    elementwise kernel 100-140, a launch on the host: busy 90 µs a step."""
    ev = []
    for s in range(2):
        t = 1000.0 * s
        ev += [_x("cudaLaunchKernel", t, 2, "cuda_runtime", tid=1), _x(BAND, t, 30, "kernel"),
               _x("Memcpy HtoD", t + 20, 30, "gpu_memcpy"), _x(OTHER, t + 100, 40, "kernel")]
    return ev


def _read(name, m):
    return common.reader(name, common.BENCH_DIR).read(m)


def test_device_readers_by_hand():
    m = {"trace_events": _trace(), "profiled_steps": 2, "step_ops": 3.0e9, "peak_flops": 6.7e13,
         "launch_bounds": [{"bound_ms": 0.015}], "window_samples_per_s": 123.5}
    assert tracing.busy_us(m["trace_events"]) == 180.0
    busy_s = 90.0 / 1e6
    assert math.isclose(_read("step_mfu.train_device", m), 100.0 * 3.0e9 / busy_s / 6.7e13,
                        rel_tol=1e-12)
    assert _read("kernel_roofline.train_device", m) == _read("kernel_roofline.train", m)
    assert math.isclose(_read("kernel_roofline.train_device", m), 50.0, rel_tol=1e-12)
    assert _read("window_samples_per_s.train", m) == 123.5


@pytest.mark.parametrize("name", ["step_mfu.train_device", "kernel_roofline.train_device",
                                  "window_samples_per_s.train"])
def test_none_without_what_they_read(name):
    host_only = [e for e in _trace() if e["cat"] == "cuda_runtime"]
    assert _read(name, {"trace_events": host_only, "profiled_steps": 2, "step_ops": 1.0,
                        "peak_flops": 1.0}) is None


@pytest.mark.parametrize("listed", [True, False])
def test_trace0_reads_the_device_step_after_the_window(monkeypatch, listed):
    """A toy run with --trace 0: where the cell lists the device time a
    step, one stretch of the mix's profile_steps is profiled after the
    window and its busy time over those steps is the metric; where it does
    not, nothing is profiled."""
    chunks, profiled = [], []
    run_chunk = program.run_chunk

    def chunk(t, k, sg, sd):
        chunks.append(k)
        return run_chunk(t, k, sg, sd)

    def profile(fn, path, sync):
        profiled.append(len(chunks))
        fn()
        return _trace()

    monkeypatch.setattr(program, "run_chunk", chunk)
    monkeypatch.setattr(tracing, "profile", profile)
    cf, mix = toy.with_settings(toy.config()), toy.TRAIN_MIX
    e2e = [{"name": "setup_s", "unit": "s"}, {"name": "train_samples_per_s", "unit": "samples/s"}]
    if listed:
        e2e.append({"name": train_cell.DEVICE_STEP, "unit": "ms"})
    result, checks = train_cell.run(toy.args(seconds=0.2, trace=0), 0.0,
                                    {"end_to_end": e2e, "per_layer": []},
                                    {"name": "toy.train"}, cf, mix, device="cpu")
    assert result["correct"], checks
    assert list(result["metrics"]) == [s["name"] for s in e2e]
    if listed:
        assert len(profiled) == 1 and chunks[-1] == mix["profile_steps"]
        assert profiled[0] == len(chunks) - 1          # after every window chunk
        want = tracing.busy_us(_trace()) / 1e3 / mix["profile_steps"]
        assert result["metrics"][train_cell.DEVICE_STEP] == {"value": want, "unit": "ms"}
    else:
        assert profiled == []
