"""The readers of the program's train spans (`spans.py`, the idle_*.train
and optimizer_launches.train metrics) on hand-built Chrome traces whose
idle time and launches inside each span are known."""

import pytest

from bench_port import common, spans

HOST, OTHER = 10, 11          # the thread that runs the steps, another one
IDLE = ("idle_gather.train", "idle_forward.train", "idle_backward.train",
        "idle_optimizer.train")


def _x(name, ts, dur, cat, tid=HOST, pid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def _span(name, a, b, tid=HOST):
    return _x(name, a, b - a, "user_annotation", tid)


def _kernel(a, b):
    return _x("k", a, b - a, "kernel", tid=7, pid=0)


def _launch(ts, tid=HOST, name="cudaLaunchKernel"):
    return _x(name, ts, 1, "cuda_runtime", tid)


def _trace():
    """A chunk of two steps from 90 to 310 µs (the window: 220 µs). Each
    step [s, s+100]: gather [s, s+10], forward [s+10, s+50], backward
    [s+50, s+80], optimizer [s+80, s+100]; kernels [s-5, s+5], [s+20,
    s+40], [s+60, s+85]; the noise [90, 100], the screen [300, 310], a
    last copy [305, 310]. Idle: gather 5 + 5, forward 20 + 20, backward
    10 + 10, optimizer 10 + 15 (the second step's first kernel starts at
    195), the noise 5, the screen 5: 105 µs."""
    ev = [_span("train.noise", 90, 100), _span("train.screen", 300, 310),
          _x("Memcpy DtoH", 305, 5, "gpu_memcpy", tid=7, pid=0)]
    for s in (100, 200):
        ev += [_span("train.step", s, s + 100), _span("train.gather", s, s + 10),
               _span("train.forward", s + 10, s + 50), _span("train.backward", s + 50, s + 80),
               _span("train.optimizer", s + 80, s + 100),
               _kernel(s - 5, s + 5), _kernel(s + 20, s + 40), _kernel(s + 60, s + 85),
               # the device's own annotation of the span: not a host span
               _x("train.optimizer", s + 60, 40, "gpu_user_annotation", tid=7, pid=0)]
        ev += [_launch(s + 81), _launch(s + 90), _launch(s + 99, name="cuLaunchKernel"),
               _launch(s + 70),                          # in backward
               _launch(s + 85, tid=OTHER),               # another thread
               _launch(s + 95, name="cudaMemcpyAsync"),  # not a launch
               _launch(s + 100)]                         # at the span's end: outside
    ev.append(_launch(305))
    # a span of the same name on another thread, holding launches
    ev += [_span("train.optimizer", 250, 290, tid=OTHER), _launch(260, tid=OTHER)]
    return ev


def _read(name, m):
    return common.reader(name).read(m)


def test_idle_shares_by_hand():
    m = {"trace_events": _trace(), "profiled_steps": 2}
    got = {k: _read(k, m) for k in IDLE}
    assert got == pytest.approx({"idle_gather.train": 100 * 10 / 220,
                                 "idle_forward.train": 100 * 40 / 220,
                                 "idle_backward.train": 100 * 20 / 220,
                                 "idle_optimizer.train": 100 * 25 / 220})
    # the four partition part of device_idle.train; the rest is the
    # noise's 5 and the screen's 5
    idle = _read("device_idle.train", m)
    assert idle == pytest.approx(100 * 105 / 220)
    assert idle - sum(got.values()) == pytest.approx(100 * 10 / 220)


def test_optimizer_launches_by_hand():
    """Kernel and graph launches that start inside train.optimizer on the
    steps' thread: 3 a step; the backward's, another thread's, a copy's and
    one at the span's end are not counted."""
    m = {"trace_events": _trace(), "profiled_steps": 2}
    assert _read("optimizer_launches.train", m) == 3.0
    assert _read("host_launches.train", m) == (2 * 6 + 1 + 1) / 2


def test_the_steps_thread_is_the_one_with_train_step_spans():
    ev = [e for e in _trace() if e["tid"] != OTHER or e["name"] != "train.optimizer"]
    # move every host event to another thread id: still one thread
    moved = [{**e, "tid": 99} if e["tid"] == HOST else e for e in ev]
    m = {"trace_events": moved, "profiled_steps": 2}
    assert _read("optimizer_launches.train", m) == 3.0
    assert set(spans.spans(moved)) == {"train.noise", "train.step", "train.gather",
                                       "train.forward", "train.backward", "train.optimizer",
                                       "train.screen"}


@pytest.mark.parametrize("name", IDLE + ("optimizer_launches.train",))
def test_none_without_device_events_or_spans(name):
    ev = _trace()
    host_only = [e for e in ev if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert _read(name, {"trace_events": host_only, "profiled_steps": 2}) is None
    no_spans = [e for e in ev if e["cat"] != "user_annotation"]      # an older program
    assert _read(name, {"trace_events": no_spans, "profiled_steps": 2}) is None
    assert _read(name, {}) is None


def test_span_names_are_the_programs():
    from cape_tpu_torch.train.metrics import TRAIN_SPANS

    assert spans.TRAIN_SPANS == TRAIN_SPANS
