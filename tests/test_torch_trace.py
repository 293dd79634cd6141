"""The phase spans of the port's train loop (`train.metrics.span`,
`TRAIN_SPANS`): the profiler flag that gates them, no span object at all
while no profiler runs, the spans of a dispatch chunk under the CPU
profiler (their counts, their nesting in each step, the train.reduce span
under a process group), and the chunk's losses and parameters unchanged
by them, bit for bit. The model's own span (`MODEL_SPANS`: `CAPE.encode`'s
`model.encode`) in a profiled step of configs/default_config.yaml's
family: one a step, on the step's thread, inside `train.forward`.

The model is the multihost selftest's (`parallel.multihost._tiny`: the
icosphere(3) model at nf=4, batch 8); default_config.yaml's family is the
same at its own switches (residual encoder blocks, conditions on the
encoder, a 4-channel bottleneck, the GraphCMR decoder, no edge loss). The
process-group case runs this file as a script (`python
tests/test_torch_trace.py reduce <port>`): one Gloo rank, one thread, a
timeout.
"""

import collections
import dataclasses
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 2   # steps in the chunk
PHASES = ("train.gather", "train.forward", "train.backward", "train.reduce", "train.optimizer")


def _tiny():
    from cape_tpu_torch.parallel.multihost import _tiny

    return _tiny("trace_test", 1)


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


@pytest.fixture(scope="module")
def tiny_default():
    """The selftest's model and data in configs/default_config.yaml's
    family: its switches over the selftest's widths (the context does not
    depend on them), at nf=2 so that each GraphCMR group norm, the
    conditions' 12 channels included, holds at most 32 channels."""
    cfg, ctx, data = _tiny()
    cfg = dataclasses.replace(cfg, name="trace_default", nf=2, use_res_block=True,
                              use_res_block_dec=True, cond_encoder=True, affine=False,
                              reduce_dim=4, lambda_edge=0.0, lr_warmup=False)
    return cfg, ctx, data


def _trainer(tiny, workdir):
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.parallel.multihost import _model
    from cape_tpu_torch.train.loop import Trainer

    cfg, ctx, data = tiny
    t = Trainer(cfg, _model(cfg, ctx), ctx, data, workdir=str(workdir))
    n = len(data.disp_train)
    return t, BatchStream(n, cfg.batch_size, 0), BatchStream(n, cfg.batch_size, 1)


def _chunk(t, sg, sd):
    """K steps through run_steps, closed by the loss screen, as fit takes
    them: each step's (loss_g, loss_d)."""
    metrics = t.run_steps(K, sg, sd)
    t._screen([(i, torch.stack([m["loss_g"], m["loss_d"]])) for i, m in enumerate(metrics)])
    return [(m["loss_g"].item(), m["loss_d"].item()) for m in metrics]


def _spans(prof, path, names=None) -> list[tuple[str, float, float, int]]:
    """(name, start, end, tid) of the trace's events named in `names`
    (TRAIN_SPANS by default), by start (a span before those it holds)."""
    from cape_tpu_torch.train.metrics import TRAIN_SPANS

    names = TRAIN_SPANS if names is None else names
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] in names),
                  key=lambda s: (s[1], -s[2]))


def _profiled_chunk(tiny, tmp_path, names=None):
    t, sg, sd = _trainer(tiny, tmp_path)
    _chunk(t, sg, sd)   # the first update has no momentum yet
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _chunk(t, sg, sd)
    return _spans(prof, tmp_path / "trace.json", names)


def test_the_profiler_flag_is_set_inside_a_profile_only():
    """The gate of every span: a torch that drops this flag fails here
    instead of losing every span without a sound."""
    from cape_tpu_torch.train.metrics import span

    flag = lambda: torch.autograd.profiler._is_profiler_enabled
    assert flag() is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert flag() is True
        assert isinstance(span("train.step"), torch.profiler.record_function)
    assert flag() is False
    assert span("train.step") is span("train.screen")   # one shared null context


def test_no_span_object_while_no_profiler_runs(tiny, tmp_path, monkeypatch):
    made = []
    real = torch.autograd.profiler.record_function.__init__

    def counting(self, *args, **kwargs):
        made.append(args[0] if args else kwargs.get("name"))
        real(self, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", counting)
    t, sg, sd = _trainer(tiny, tmp_path)
    _chunk(t, sg, sd)
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _chunk(t, sg, sd)
    assert collections.Counter(made)["train.step"] == K   # the count sees them when on


def test_one_span_per_phase_and_step(tiny, tmp_path):
    spans = _profiled_chunk(tiny, tmp_path)
    counts = collections.Counter(name for name, *_ in spans)
    assert counts == {"train.noise": 1, "train.screen": 1, "train.step": K, "train.gather": K,
                      "train.forward": K, "train.backward": K, "train.optimizer": K}
    assert len({tid for *_, tid in spans}) == 1   # all on the thread that ran the chunk


def test_phases_lie_in_their_step_in_order_without_overlap(tiny, tmp_path):
    spans = _profiled_chunk(tiny, tmp_path)
    steps = [(a, b) for name, a, b, _ in spans if name == "train.step"]
    (noise,) = [(a, b) for name, a, b, _ in spans if name == "train.noise"]
    (screen,) = [(a, b) for name, a, b, _ in spans if name == "train.screen"]
    assert noise[1] <= steps[0][0] and steps[-1][1] <= screen[0]
    assert steps[0][1] <= steps[1][0]
    for a, b in steps:
        inside = sorted((s, e, name) for name, s, e, _ in spans if name in PHASES and a <= s < b)
        assert [name for *_, name in inside] == [
            "train.gather", "train.forward", "train.backward", "train.optimizer"]
        assert all(a <= s and e <= b for s, e, _ in inside)
        assert all(inside[i][1] <= inside[i + 1][0] for i in range(len(inside) - 1))


def test_spans_change_no_loss_or_parameter(tiny, tmp_path):
    """Two trainers from the same parameters and streams, one chunk with
    the profiler (and so every span) on and one with it off: the same
    losses and parameters, bit for bit."""
    runs = []
    for profiled in (False, True):
        t, sg, sd = _trainer(tiny, tmp_path / str(profiled))
        losses = _chunk(t, sg, sd)
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                losses += _chunk(t, sg, sd)
        else:
            losses += _chunk(t, sg, sd)
        runs.append((losses, {n: p.detach().clone() for n, p in t.model.named_parameters()}))
    (want_losses, want), (got_losses, got) = runs
    assert got_losses == want_losses
    assert got.keys() == want.keys()
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=0, msg=n)


def test_model_spans_are_not_train_spans():
    from cape_tpu_torch.train.metrics import MODEL_SPANS, TRAIN_SPANS, span

    assert MODEL_SPANS == ("model.encode",)
    assert not set(MODEL_SPANS) & set(TRAIN_SPANS)
    # while no profiler runs, the model's span is the train spans' one
    # shared null context
    assert span("model.encode") is span("train.step")


def test_one_encode_span_per_step_inside_its_forward(tiny_default, tmp_path):
    """A profiled chunk of configs/default_config.yaml's family: one
    model.encode a step, on the thread that runs the steps (the encoder's
    backward runs on autograd's), each inside its step's train.forward."""
    from cape_tpu_torch.train.metrics import MODEL_SPANS, TRAIN_SPANS

    cfg = tiny_default[0]
    assert (cfg.use_res_block, cfg.cond_encoder, cfg.fold_conditions, cfg.reduce_dim) == (
        True, True, True, 4)
    spans = _profiled_chunk(tiny_default, tmp_path, TRAIN_SPANS + MODEL_SPANS)
    counts = collections.Counter(name for name, *_ in spans)
    assert counts["model.encode"] == counts["train.step"] == K
    assert len({tid for *_, tid in spans}) == 1
    forwards = [(a, b) for name, a, b, _ in spans if name == "train.forward"]
    encodes = [(a, b) for name, a, b, _ in spans if name == "model.encode"]
    assert len(forwards) == K
    for (fa, fb), (ea, eb) in zip(forwards, encodes):
        assert fa <= ea and eb <= fb


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_reduce_span_under_a_process_group():
    """One Gloo rank of a group of one: the Trainer takes the group, and
    every step gains its train.reduce between backward and optimizer."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "reduce",
                           str(_free_port())], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    order = json.loads(proc.stdout.strip().splitlines()[-1])
    assert order == ["train.noise"] + K * [
        "train.step", "train.gather", "train.forward", "train.backward", "train.reduce",
        "train.optimizer"] + ["train.screen"]


def _reduce_rank(port: int) -> None:
    """Print the order of the spans of a profiled chunk in a Gloo group of
    one (the first chunk unprofiled)."""
    import tempfile

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            from pathlib import Path

            spans = _profiled_chunk(_tiny(), Path(tmp))
    finally:
        dist.destroy_process_group()
    print(json.dumps([name for name, *_ in spans]))


if __name__ == "__main__" and sys.argv[1:2] == ["reduce"]:
    _reduce_rank(int(sys.argv[2]))
