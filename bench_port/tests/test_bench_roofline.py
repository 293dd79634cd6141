"""`kernel_roofline.train`'s bounds come from the band applies of the
set-up's steps, not from the profiled stretch's: the share read from them
on hand-built traces (CPU), the train runner keeping its recorder on over
the set-up alone (CPU, toy size), and on the card a band apply replayed
from a CUDA graph seen in the trace and read at its eager share, and each
train cell's share from the set-up's records against the stretch's own
on one trace."""

import math
import time

import pytest
import torch

from bench_port import common, program, roofline, tracing, train_cell
from bench_port.tests import toy

torch.set_num_threads(2)

BAND = "void band_gather_kernel<float>(float const*, int const*, float const*, float*, int)"
OTHER = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >()"
STEPS = 4          # the profiled stretch's steps


def _blocks(seed: int, shape) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) < 0.3).float()


def _step() -> list[tuple]:
    """One step's band applies as `program.LaunchRecorder` records them:
    (blocks, pad_left, rows_out, B, rows_in, C, dtype, addend)."""
    fine, coarse = _blocks(1, (3, 4, 128, 128)), _blocks(2, (2, 2, 128, 64))
    return [(fine, 64, 500, 32, 512, 64, torch.float32, False),
            (fine, 64, 500, 32, 512, 64, torch.float32, True),
            (coarse, 0, 250, 32, 128, 16, torch.float32, False),
            (coarse, 0, 250, 16, 128, 128, torch.float32, True)]


def _x(name, ts, dur, cat, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def _trace(n_applies: int, graph: bool = False, port: bool = True) -> list[dict]:
    """STEPS steps of n_applies band-gather launches each, apply j of step s
    taking 20 + 7 j + s µs on the device, beside an elementwise kernel a
    step; launched one by one (cudaLaunchKernel) or by one graph launch a
    step (cudaGraphLaunch). port=False: the band kernels left out."""
    ev, t = [], 0.0
    for s in range(STEPS):
        if graph:
            ev.append(_x("cudaGraphLaunch", t, 3, "cuda_runtime"))
        for j in range(n_applies):
            if not graph:
                ev.append(_x("cudaLaunchKernel", t, 2, "cuda_runtime"))
            if port:
                ev.append(_x(BAND, t + 5, 20 + 7 * j + s, "kernel", tid=7))
            t += 100
        ev.append(_x(OTHER, t, 10, "kernel", tid=7))
        t += 100
    return ev


def _by_hand(step: list[tuple]) -> float:
    """The share of _trace(len(step)): one step's mean bound over the mean
    duration of its band launches, in %."""
    bound = sum(roofline.apply_bound(b, B, ri, ro, C, dt, ad)["bound_ms"]
                for b, _, ro, B, ri, C, dt, ad in step) / len(step)
    durs = [20 + 7 * j + s for s in range(STEPS) for j in range(len(step))]
    return 100.0 * bound / (sum(durs) / len(durs) / 1000.0)


def _share(events, records):
    return tracing.roofline_share({"trace_events": events,
                                   "launch_bounds": tracing.launch_bounds(records)})


@pytest.mark.parametrize("k", [1, 3, 5])
def test_setup_records_read_the_stretch_share(k):
    """k steps' records (the set-up's) give the share that the stretch's
    own STEPS steps of records gave, and the share by hand."""
    step = _step()
    events = _trace(len(step))
    stretch = _share(events, step * STEPS)
    setup = _share(events, step * k)
    assert math.isclose(setup, stretch, rel_tol=1e-12, abs_tol=0)
    assert math.isclose(setup, _by_hand(step), rel_tol=1e-12, abs_tol=0)


def test_a_stretch_without_records_of_its_own_reads_a_number():
    """A stretch replayed from graphs: its host launched graphs, no band
    apply was recorded in it, and its kernels read against the set-up's
    records."""
    step = _step()
    events = _trace(len(step), graph=True)
    assert tracing.launches(events) == STEPS
    assert math.isclose(_share(events, step * 3), _by_hand(step), rel_tol=1e-12, abs_tol=0)


@pytest.mark.parametrize("port, records", [(False, True), (True, False)],
                         ids=["no_port_kernel", "no_record"])
def test_none_without_a_port_kernel_or_a_record(port, records):
    step = _step()
    events = _trace(len(step), port=port)
    assert _share(events, step * 3 if records else []) is None
    if not records:
        assert tracing.roofline_share({"trace_events": events}) is None


@pytest.mark.parametrize("trace", [0, 1])
def test_recorder_on_over_the_setup_alone(monkeypatch, trace):
    """A whole toy run on the CPU, each run_chunk told apart: with --trace
    1 one recorder is on over the first steps and the warm chunk, and off
    in the window and the profiled stretch, and launch_bounds reads what it
    recorded; with --trace 0 no recorder is made."""
    made, on, chunks, given = [], [], [], []

    class Recorder:
        def __init__(self):
            self.records = []
            made.append(self)

        def __enter__(self):
            on.append(self)
            return self

        def __exit__(self, *exc):
            on.remove(self)

    run_chunk = program.run_chunk

    def chunk(t, k, sg, sd):
        chunks.append((k, bool(on)))
        for r in on:
            r.records += [("apply",)] * k    # stands for one step's applies
        return run_chunk(t, k, sg, sd)

    monkeypatch.setattr(program, "LaunchRecorder", Recorder)
    monkeypatch.setattr(program, "run_chunk", chunk)
    monkeypatch.setattr(tracing, "launch_bounds", lambda records: given.append(records) or [])
    cf, mix = toy.with_settings(toy.config()), toy.TRAIN_MIX
    bench = {"end_to_end": [{"name": "setup_s", "unit": "s"},
                            {"name": "train_samples_per_s", "unit": "samples/s"}],
             "per_layer": []}
    result, checks = train_cell.run(toy.args(seconds=0.2, trace=trace), 0.0, bench,
                                    {"name": "toy.train"}, cf, mix, device="cpu")
    assert result["correct"], checks
    setup = [(1, bool(trace)), (train_cell.CHECK_STEPS - 1, bool(trace)),
             (mix["steps_per_dispatch"], bool(trace))]
    assert chunks[:3] == setup
    assert not any(rec for _, rec in chunks[3:])
    if trace:
        assert len(made) == 1 and chunks[-1] == (mix["profile_steps"], False)
        assert given == [[("apply",)] * (train_cell.CHECK_STEPS + mix["steps_per_dispatch"])]
    else:
        assert made == [] and given == []


@pytest.mark.card
def test_graph_replay_is_traced_at_its_eager_share(card, tmp_path):
    """Plain BandedOp applies of the affine cell's context (its banded
    pools and unpools and its finest Laplacian at batch 32, 64 channels), warmed up
    eagerly and captured in a CUDA graph with the recorder on, then run
    eagerly and replayed, each under the profiler with the recorder off:
    every replayed band-gather launch is in the trace with its duration,
    and the share from the recorded bounds reads within 10% of the eager
    one."""
    bench = common.benchmark(toy.REPO)
    wl = common.workload(bench, "affine_nz64.train.f32b32")
    cf, mix = common.config_file(bench, wl["config"]), common.traffic_file(wl["traffic"])
    cfg = train_cell.program_config(cf, mix, toy.SEED, "graph")
    ctx = program.context(cfg, card)
    # the banded ones (a level's identity pool is no BandedOp)
    ops = [op for op in (*ctx.down, *ctx.up, ctx.lap[0]) if getattr(op, "pack", None) is not None]
    assert len(ops) >= 5
    gen = torch.Generator(card).manual_seed(toy.SEED)
    xs = [torch.randn(32, op.rows_in, 64, device=card, generator=gen) for op in ops]
    applies = lambda: [op(x) for op, x in zip(ops, xs)]
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad():
        with program.LaunchRecorder() as recorder:
            side = torch.cuda.Stream(card)
            side.wait_stream(torch.cuda.current_stream(card))
            with torch.cuda.stream(side):
                eager_out = applies()
            torch.cuda.current_stream(card).wait_stream(side)
            with torch.cuda.graph(graph):
                graph_out = applies()
        reps = 20
        sync = torch.cuda.synchronize
        path = str(tmp_path / "trace.json")
        eager = tracing.profile(lambda: [applies() for _ in range(reps)], path, sync)
        replay = tracing.profile(lambda: [graph.replay() for _ in range(reps)], path, sync)
    for a, b in zip(eager_out, graph_out):
        assert torch.equal(a, b)
    assert len(recorder.records) == 2 * len(ops)
    band = [e for e in tracing.device_events(replay) if "band_gather_kernel" in e["name"]]
    assert len(band) == reps * len(ops) and all(e["dur"] > 0 for e in band)
    assert tracing.kernel_us(eager, ("band_gather_kernel",))[1] == reps * len(ops)
    bounds = tracing.launch_bounds(recorder.records)
    shares = [tracing.roofline_share({"trace_events": ev, "launch_bounds": bounds})
              for ev in (eager, replay)]
    print(f"card: {common.power_limit()}; {len(ops)} applies x {reps}; graph launches "
          f"{tracing.launches(replay)}; share eager {shares[0]:.4f}%, replayed {shares[1]:.4f}%")
    assert abs(shares[1] / shares[0] - 1) < 0.10


TRAIN_CELLS = [w["name"] for w in common.benchmark(toy.REPO)["workloads"]
               if common.traffic_file(w["traffic"])["kind"] == "train"]


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_setup_bounds_read_the_stretch_share_on_one_trace(card, monkeypatch, cell):
    """A traced run of the cell at its own size (a 2 s window): the share
    as the run reports it (the set-up's records) against the share from
    the records of the profiled stretch itself, over the same trace."""
    bench = common.benchmark(toy.REPO)
    wl = common.workload(bench, cell)
    cf, mix = common.config_file(bench, wl["config"]), common.traffic_file(wl["traffic"])
    stretch, seen = program.LaunchRecorder(), {}
    profile, launch_bounds = tracing.profile, tracing.launch_bounds

    def profile_recording(fn, path, sync):
        with stretch:
            seen["events"] = profile(fn, path, sync)
        return seen["events"]

    def setup_bounds(records):
        seen["setup"] = len(records)
        return launch_bounds(records)

    monkeypatch.setattr(tracing, "profile", profile_recording)
    monkeypatch.setattr(tracing, "launch_bounds", setup_bounds)
    result, checks = train_cell.run(toy.args(seconds=2.0, trace=1), time.perf_counter(), bench,
                                    wl, cf, mix)
    old = tracing.roofline_share({"trace_events": seen["events"],
                                  "launch_bounds": launch_bounds(stretch.records)})
    new = result["metrics"]["kernel_roofline.train"]["value"]
    print(f"card: {common.power_limit()}; {cell}: set-up records {seen['setup']}, "
          f"stretch records {len(stretch.records)}; share set-up {new!r}%, stretch {old!r}%")
    assert result["correct"], checks
    assert math.isclose(new, old, rel_tol=1e-6, abs_tol=0)
