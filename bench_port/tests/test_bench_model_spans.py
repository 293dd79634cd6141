"""The readers of the program's model spans (`model_spans.py`,
encode_launches.train and idle_encode.train) on the hand-built Chrome
trace of `test_bench_spans.py`, with a `model.encode` span added inside
each step's forward, whose idle time and launches are known."""

import pytest

from bench_port import common, model_spans, spans
from bench_port.tests.test_bench_spans import HOST, IDLE, OTHER, _launch, _span, _trace

ENCODE = ("encode_launches.train", "idle_encode.train")


def _read(name, m):
    return common.reader(name).read(m)


def _encode_trace():
    """_trace() with a model.encode span in each step's forward, [s+12,
    s+45]: idle 8 + 5 a step beside the forward's kernel [s+20, s+40];
    launches at s+15 and s+30 inside it and, not counted, a copy's call,
    a launch at the span's end and one on another thread. Another
    thread's model.encode span, with a launch in it (a server's engine,
    say), is not the steps' thread's."""
    ev = _trace()
    for s in (100, 200):
        ev += [_span("model.encode", s + 12, s + 45), _launch(s + 15), _launch(s + 30),
               _launch(s + 25, name="cudaMemcpyAsync"), _launch(s + 45),
               _launch(s + 16, tid=OTHER)]
    ev += [_span("model.encode", 150, 180, tid=OTHER), _launch(160, tid=OTHER)]
    return ev


def test_encode_readers_by_hand():
    m = {"trace_events": _encode_trace(), "profiled_steps": 2}
    assert _read("encode_launches.train", m) == 2.0
    assert _read("idle_encode.train", m) == pytest.approx(100 * 26 / 220)
    # the train spans' readers read as they did without the model's span
    before = {"trace_events": _trace(), "profiled_steps": 2}
    for name in IDLE + ("optimizer_launches.train",):
        assert _read(name, m) == _read(name, before), name
    assert _read("idle_encode.train", m) <= _read("idle_forward.train", m)


@pytest.mark.parametrize("name", ENCODE)
def test_none_without_device_events_or_the_span(name):
    ev = _encode_trace()
    host_only = [e for e in ev if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert _read(name, {"trace_events": host_only, "profiled_steps": 2}) is None
    # a program without the span (an older checkout), and one without any
    assert _read(name, {"trace_events": _trace(), "profiled_steps": 2}) is None
    no_spans = [e for e in ev if e["cat"] != "user_annotation"]
    assert _read(name, {"trace_events": no_spans, "profiled_steps": 2}) is None
    # the span on another thread only
    elsewhere = [e for e in ev if not (e["name"] == "model.encode" and e["tid"] == HOST)]
    assert _read(name, {"trace_events": elsewhere, "profiled_steps": 2}) is None
    assert _read(name, {}) is None


def test_model_span_names_are_the_programs():
    from cape_tpu_torch.train.metrics import MODEL_SPANS

    assert model_spans.MODEL_SPANS == MODEL_SPANS
    assert not set(model_spans.MODEL_SPANS) & set(spans.TRAIN_SPANS)
    assert set(model_spans.model_spans(_encode_trace())) == {"model.encode"}
