"""The port's lab (`cape_tpu_torch.tools.perf_lab`) on the CPU: every
subcommand runs end to end on the flagship context with the CUDA-event
timer replaced by a stub that runs the timed call once, and prints the
JSON lines of the JAX lab with the renamed keys. The kernel subcommands run
at batch 4 and 8 channels; the model subcommands (parts, step, serve,
trace) on the flagship cut to nf=8, and http and concurrency against a
live port server of that model. `trace`'s attribution is held on a
hand-written Chrome trace. The lab refuses to run without a GPU unless
asked for the CPU."""

import functools
import json

import pytest
import torch

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--batch", "4", "--channels", "8"]
TIMES = lambda *names: {f"{n}_{p}_ms" for n in names for p in ("fwd", "fwdbwd")}
# (argv, keys of each line, error fields); the lines of every dtype
CASES = {
    "conv": (["conv"], {"conv", "B", "C", "level", "padded", "device"}
             | TIMES("plain", "v5", "v2", "v1"),
             ("max_rel_err_v5", "max_rel_err_v2", "max_rel_err_v1")),
    "conv_padded": (["conv", "--padded", "1"], {"conv", "B", "C", "level", "padded", "device"}
                    | TIMES("plain", "v5"), ("max_rel_err_v5",)),
    "layout": (["layout"], {"layout", "B", "C", "device"} | TIMES("bm", "vm", "vm_kernel"),
               ("max_rel_err", "max_rel_err_vm_kernel")),
    "fuse": (["fuse"], {"fuse", "B", "C", "F", "level", "S", "variant", "fwd_ms", "fwdbwd_ms",
                        "device"}, ("max_rel_err",)),
    "bmapply": (["bmapply"], {"bmapply", "B", "C", "level", "S", "plain_ms", "bm_ms", "cf_ms",
                              "device"}, ("max_rel_err", "max_rel_err_cf")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_subcommand_prints_its_lines(case, monkeypatch, capsys):
    """Each subcommand's lines carry the renamed keys, a time from the timer
    for every route, and errors against the plain route within f32
    rounding (1e-5) or, in bf16, within the JAX lab's own 5e-2 check. CPU
    tensors launch no kernel."""
    from cape_tpu_torch.ops.kernels import counts
    from cape_tpu_torch.tools import perf_lab

    timed = []

    def stub(routes):
        for fn in routes.values():
            fn()
            timed.append(1)
        return dict.fromkeys(routes, 1.5)

    monkeypatch.setattr(perf_lab, "time_routes", stub)
    argv, keys, errs = CASES[case]
    kernel_keys = ("band_apply.conv", "cheb2_fused.g1", "cheb2_fused", "band_apply_bm")
    before = [counts[k] for k in kernel_keys]
    perf_lab.main(argv + SMALL)
    assert [counts[k] for k in kernel_keys] == before
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    tag = argv[0]
    dtypes = {"bmapply": ["bfloat16"], "fuse": ["float32"] * 4 + ["bfloat16"] * 4}.get(
        tag, ["float32", "bfloat16"])
    assert [line[tag] for line in lines] == dtypes
    if tag == "fuse":
        assert [line["variant"] for line in lines[:4]] == [
            "prod", "stacked", "projfirst", "projfirst_stacked"]
    ms = [k for k in keys if k.endswith("_ms")]
    assert len(timed) == len(ms) * len(lines)
    for line in lines:
        assert set(line) == keys | set(errs), sorted(set(line) ^ (keys | set(errs)))
        assert line["device"] == "cpu" and line["B"] == 4 and line["C"] == 8
        assert all(line[k] == 1.5 for k in ms)
        limit = 1e-5 if line[tag] == "float32" else 5e-2
        for k in errs:
            assert 0.0 <= line[k] <= limit, (k, line[k])


def test_lab_needs_a_gpu(monkeypatch):
    """The default device is cuda; without a GPU the lab raises rather than
    going on on the CPU, and its timer refuses to time."""
    from cape_tpu_torch.tools import perf_lab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        perf_lab.main([])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        perf_lab.main(["conv", "--batch", "4"])
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        perf_lab.time_routes({"noop": lambda: None})


def _record(seen, name, real, *a, **k):
    seen.add(name)
    return real(*a, **k)


# the routes of each subcommand that run a kernel wrapper; the others are plain
KERNEL_ROUTES = {"conv": {"v5", "v2", "v1"}, "layout": {"vm_kernel"}}


@pytest.mark.parametrize("cmd", list(KERNEL_ROUTES))
def test_plain_route_stays_plain_under_the_override(cmd, monkeypatch, capsys):
    """CAPE_TPU_PALLAS=1 puts cheb_conv's K=2 convs on a kernel route, but
    the lab's plain route, which every error is measured against, still
    calls no kernel wrapper, while each kernel route calls one."""
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck
    from cape_tpu_torch.tools import perf_lab

    monkeypatch.setenv("CAPE_TPU_PALLAS", "1")
    seen = set()
    for name in ("band_apply", "fused_cheb2", "banded_apply_bm"):
        monkeypatch.setattr(ck, name, functools.partial(_record, seen, name, getattr(ck, name)))
    reached = {}

    def stub(routes):
        for key, fn in routes.items():
            seen.clear()
            fn()
            reached[key] = set(seen)
        return dict.fromkeys(routes, 1.5)

    monkeypatch.setattr(perf_lab, "time_routes", stub)
    perf_lab.main([cmd] + SMALL)
    assert len(capsys.readouterr().out.splitlines()) == 2
    assert reached
    for key, wrappers in reached.items():
        route = key.rsplit("_", 2)[0]
        assert bool(wrappers) == (route in KERNEL_ROUTES[cmd]), (key, wrappers)


# the flagship cut to nf=8 for the model subcommands (full template, both pyramids)
NARROW = dict(nz=8, nz_cond=8, nz_cond2=4, nf=8, reduce_dim=8)


@pytest.fixture
def narrow(monkeypatch):
    from cape_tpu_torch.tools import flagship

    for k, v in NARROW.items():
        monkeypatch.setitem(flagship.FLAGSHIP, k, v)


def _stub_timer(monkeypatch, perf_lab):
    timed = []

    def stub(routes, **kw):
        for fn in routes.values():
            fn()
        timed.append(sorted(routes))
        return dict.fromkeys(routes, 1.5)

    monkeypatch.setattr(perf_lab, "time_routes", stub)
    return timed


def _spy(monkeypatch, owner, name, calls):
    real = getattr(owner, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(owner, name, spy)


def _json_lines(out: str) -> list[dict]:
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


# argv, keys of each line, number of lines; the trace writes to tmp_path
MODEL_CASES = {
    "parts": (["parts", "--batch", "2"],
              {"part", "dtype", "fwd_ms", "fwdbwd_ms", "ratio", "max_rel_err", "device"}, 3),
    "step": (["step", "--batch", "2", "--k", "1"],
             {"step_ms", "steps_per_sec", "dtype", "batch", "steps_per_dispatch", "padded",
              "fuse_decoder", "device"}, 1),
    "serve": (["serve", "--inner", "1"],
              {"bench", "batch", "dtype", "padded", "inner", "decode_ms_per_call",
               "decode_meshes_per_sec", "reconstruct_ms_per_call", "reconstruct_samples_per_sec",
               "single_call_decode_ms_incl_dispatch", "launches_per_decode_call", "device"}, 2),
    "trace": (["trace", "--batch", "2", "--top", "5"],
              {"cpu_op_self_ms_per_step", "wall_ms_per_step", "untraced_wall_ms_per_step",
               "ops_per_step", "batch", "dtype", "padded", "trace_dir", "time", "device"}, 1),
    "chain": (["chain", "--batch", "2", "--channels", "8", "--depth", "2", "--dtype", "both"],
              {"chain", "B", "C", "K", "depth", "level", "bm_fwd_ms", "cf_fwd_ms", "bm_fwdbwd_ms",
               "cf_fwdbwd_ms", "cfv_fwdbwd_ms", "max_rel_err", "max_rel_err_cfv", "device"}, 2),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_subcommand_prints_its_line(case, narrow, monkeypatch, capsys, tmp_path):
    """parts, step, serve, trace and chain on the CPU: each prints its keys,
    runs the production functions (the model's encode/decode/discriminate
    for parts, train_step for step and trace, InferenceEngine.decode for
    serve, ops.cheb.cheb_conv for chain's batch-major arm), launches no
    kernel on CPU tensors, and holds its checks: parts' losses equal to the
    plain route's (the same operators on the CPU, so within 1e-6), the
    chain's channels-first arms within 1e-5 (f32) or 5e-2 (bf16, the JAX
    lab's own check) of batch-major, step's and trace's times positive."""
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops import cheb
    from cape_tpu_torch.ops.kernels import counts as launched
    from cape_tpu_torch.tools import perf_lab
    from cape_tpu_torch.train import loop

    timed = _stub_timer(monkeypatch, perf_lab)
    monkeypatch.setattr(perf_lab, "SERVE_BATCHES", (1, 4))
    calls = []
    # train_step as Trainer.run_steps (the loop of Trainer.fit) calls it
    for owner, name in ((loop, "train_step"), (InferenceEngine, "decode"), (CAPE, "encode"),
                        (CAPE, "decode"), (CAPE, "discriminate"), (cheb, "cheb_conv")):
        _spy(monkeypatch, owner, name, calls)
    argv, keys, n_lines = MODEL_CASES[case]
    if case == "trace":
        argv = argv + ["--out", str(tmp_path)]
    counts = (launched["band_apply.conv"], launched["band_apply.conv_bwd"])
    result = perf_lab.main(argv + ["--device", "cpu"])
    assert (launched["band_apply.conv"], launched["band_apply.conv_bwd"]) == counts
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == n_lines
    for line in lines:
        assert set(line) == keys, sorted(set(line) ^ keys)
        assert line["device"] == "cpu"
    if case == "parts":
        assert [line["part"] for line in lines] == ["enc", "dec", "disc"]
        assert timed == [sorted(f"{p}_{t}_ms" for p in ("enc", "dec", "disc")
                                for t in ("fwd", "fwdbwd"))]
        assert all(line["max_rel_err"] <= 1e-6 and line["ratio"] == 1.0 for line in lines)
        assert {"encode", "decode", "discriminate"} <= set(calls)
    elif case == "step":
        assert lines[0]["step_ms"] > 0 and lines[0]["steps_per_sec"] > 0
        assert calls.count("train_step") == 1 + perf_lab.STEP_GROUPS   # --k 1
        assert result == lines[0]
    elif case == "serve":
        assert [line["batch"] for line in lines] == [1, 4]
        assert timed == [["decode", "reconstruct"]] * 2
        assert calls.count("decode") >= 2 * (1 + 19)   # the engine's, then the model's
        assert all(line["launches_per_decode_call"] == 0 for line in lines)
    elif case == "trace":
        line = lines[0]
        assert calls.count("train_step") == perf_lab.TRACE_WARMUP + 2 * perf_lab.TRACE_STEPS
        assert line["untraced_wall_ms_per_step"] > 0
        assert 0 < line["cpu_op_self_ms_per_step"] <= line["wall_ms_per_step"]
        assert (tmp_path / "trace.json").exists() and line["trace_dir"] == str(tmp_path)
        out = result
        assert {c for c, _, _ in out["by_category"]} <= {
            "port kernel", "copy/memset", "gemm", "reduction", "elementwise", "other"}
        assert any(op == "aten::mm" for op, _, _, _ in out["by_operator"] + [
            (k, None, 0, 0) for k, _, _, _ in out["by_kernel"]])
        assert any(f.startswith("cape_tpu_torch/") for _, f, _, _ in out["by_operator"])
    elif case == "chain":
        assert [line["chain"] for line in lines] == ["float32", "bfloat16"]
        for line in lines:
            limit = 1e-5 if line["chain"] == "float32" else 5e-2
            assert line["max_rel_err"] <= limit and line["max_rel_err_cfv"] <= limit
        assert calls.count("cheb_conv") >= 2 * 2


def test_parts_refuses_the_kernel_override(monkeypatch):
    """CAPE_TPU_PALLAS=1 would put parts' plain reference (a use_pallas=False
    context) on the kernels too, so the check would hold a kernel to
    itself: parts refuses it before it builds anything."""
    from cape_tpu_torch.tools import flagship, perf_lab

    monkeypatch.setenv("CAPE_TPU_PALLAS", "1")
    monkeypatch.setattr(flagship, "flagship_setup", None)   # reached: a TypeError
    with pytest.raises(ValueError, match="CAPE_TPU_PALLAS=1"):
        perf_lab.main(["parts", "--batch", "2", "--device", "cpu"])


@pytest.fixture(scope="module")
def live_server():
    """A port server (micro-batched, batch 4) of the flagship cut to nf=8,
    on 127.0.0.1:0, on the CPU."""
    import threading

    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.apps.server import serve
    from cape_tpu_torch.tools.flagship import flagship_setup

    _, model, ctx = flagship_setup(name="lab_http", batch_size=4, **NARROW)
    httpd, ms = serve(InferenceEngine(model, ctx, 4), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", ms
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


LIVE_CASES = {
    "http": (["http", "--batch", "2", "--reps", "3"], {"bench", "batch", "reps", "npz", "json",
                                                     "server"}),
    "concurrency": (["concurrency", "--threads", "4", "--seconds", "1.5"],
                    {"bench", "threads", "rows", "seconds", "requests", "errors", "req_per_sec",
                     "meshes_per_sec", "latency_ms_p50", "latency_ms_p95",
                     "decode_requests_per_device_call"}),
}


@pytest.mark.parametrize("case", list(LIVE_CASES))
def test_live_server_subcommand(case, live_server, monkeypatch, capsys):
    """http and concurrency through the port's CapeClient against a live
    port server: JAX's `#` lines, the JSON line's keys, every request
    answered, and the model's decode reached through the server; under
    concurrency the micro-batcher's requests per decode call from
    /stats (at least 1)."""
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.tools import perf_lab

    url, ms = live_server
    calls = []
    _spy(monkeypatch, CAPE, "decode", calls)
    argv, keys = LIVE_CASES[case]
    result = perf_lab.main(argv + ["--url", url, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"# target {url}: model=lab_http batch=4 dtype=float32")
    (line,) = _json_lines(out)
    assert set(line) == keys and line == json.loads(json.dumps(result))
    assert calls
    if case == "http":
        assert line["batch"] == 2 and line["reps"] == 3
        for wire in ("npz", "json"):
            for ep in ("sample", "reconstruct"):
                assert 0 < line[wire][ep]["p50_ms"] <= line[wire][ep]["p95_ms"]
        assert line["server"]["POST /sample"]["requests"] == 2 * (3 + 3)
        assert "# server-side /stats" in out
    else:
        assert line["errors"] == 0 and line["requests"] > 0 and line["threads"] == 4
        assert line["decode_requests_per_device_call"] >= 1


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1 if cat != "kernel" else 0,
            "tid": tid, "ts": ts, "dur": dur, "args": args}


# a hand-written trace in torch.profiler's Chrome-trace format: a host
# thread with Python frames, aten operators and kernel launches (one from
# ctypes, under no operator), and the device stream they feed
TRACE = [
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1, "args": {"name": "python"}},
    _x("python_function", "cape_tpu_torch/train/step.py(81): train_step", 0, 100),
    _x("python_function", "/repo/cape_tpu_torch/ops/cheb.py(77): cheb_conv", 10, 40),
    _x("python_function", "torch/nn/functional.py(1700): leaky_relu", 12, 5),
    _x("cpu_op", "aten::matmul", 20, 20, **{"External id": 1}),
    _x("cpu_op", "aten::mm", 21, 10, **{"External id": 2}),
    _x("cuda_runtime", "cudaLaunchKernel", 22, 3, correlation=100, **{"External id": 2}),
    _x("cuda_runtime", "cudaLaunchKernel", 45, 2, correlation=101),
    _x("cpu_op", "aten::add", 60, 5, **{"External id": 3}),
    _x("cuda_runtime", "cudaLaunchKernel", 61, 2, correlation=102, **{"External id": 3}),
    _x("kernel", "ampere_sgemm_128x64_nn", 30, 50, tid=7, correlation=100),
    _x("kernel", "void (anonymous namespace)::band_gather_kernel<float, 4, 0>(float const*, "
       "int const*, int)",
       80, 30, tid=7, correlation=101),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::"
       "CUDAFunctor_add<float>, at::detail::Array<char*, 3> >(int, at::native::"
       "CUDAFunctor_add<float>, at::detail::Array<char*, 3>)", 110, 10, tid=7, correlation=102),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5, 4, tid=7),
]


def test_trace_attribution_of_device_time():
    """Each device event's time goes to its category, to the innermost
    operator and cape_tpu_torch frame around the launch that issued it
    (linked by correlation; the ctypes launch has no operator), and to its
    kernel name stripped of template arguments; per step over 2 steps."""
    from cape_tpu_torch.tools.perf_lab import attribute

    att = attribute(TRACE, n_steps=2, top=3)
    assert att["ms_per_step"] == pytest.approx(0.047) and att["events_per_step"] == 2.0
    assert att["by_category"] == [("gemm", 25.0, 0.5), ("port kernel", 15.0, 0.5),
                                  ("elementwise", 5.0, 0.5), ("copy/memset", 2.0, 0.5)]
    cheb_frame = "cape_tpu_torch/ops/cheb.py(77): cheb_conv"
    assert att["by_operator"] == [
        ("aten::mm", cheb_frame, 25.0, 0.5), ("-", cheb_frame, 15.0, 0.5),
        ("aten::add", "cape_tpu_torch/train/step.py(81): train_step", 5.0, 0.5)]
    assert att["by_kernel"] == [
        ("ampere_sgemm_128x64_nn", "aten::mm", 25.0, 0.5), ("band_gather_kernel", "-", 15.0, 0.5),
        ("at::native::vectorized_elementwise_kernel", "aten::add", 5.0, 0.5)]
    assert att["family_counts"]["band_gather_kernel"] == 0.5
    assert att["family_counts"]["Memcpy HtoD"] == 0.5


def test_trace_attribution_of_cpu_self_time():
    """Without device time, each operator's self time (its duration less
    its child operators') is attributed, under its innermost frame."""
    from cape_tpu_torch.tools.perf_lab import attribute

    att = attribute(TRACE, n_steps=1, device_time=False)
    assert att["ms_per_step"] == pytest.approx(0.025) and att["events_per_step"] == 3
    assert att["by_category"] == [("gemm", 20.0, 2), ("elementwise", 5.0, 1)]
    cheb_frame = "cape_tpu_torch/ops/cheb.py(77): cheb_conv"
    assert att["by_operator"] == [("aten::matmul", cheb_frame, 10.0, 1),
                                  ("aten::mm", cheb_frame, 10.0, 1),
                                  ("aten::add", "cape_tpu_torch/train/step.py(81): train_step",
                                   5.0, 1)]


@pytest.mark.parametrize("name,cat,want", [
    ("void cheb2_fused_kernel<float, 64>(Conv<float>, int const*)", "kernel", "port kernel"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "kernel", "gemm"),
    ("nvjet_tst_256x128_64x4_2x1_v_bz_coopA_NNT", "kernel", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(Params)", "kernel", "gemm"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)> >(int)", "kernel", "copy/memset"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(float)", "kernel",
     "reduction"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, long>(float*)",
     "kernel", "other"),
    ("Memset (Device)", "gpu_memset", "copy/memset"),
    ("aten::bmm", "cpu_op", "gemm"),
    ("aten::leaky_relu", "cpu_op", "elementwise"),
])
def test_trace_categories(name, cat, want):
    from cape_tpu_torch.tools.perf_lab import category, kernel_family

    assert category(name, cat) == want
    family = kernel_family(name)
    assert "<" not in family and "(" not in family and not family.startswith("void ")
    assert family == kernel_family(family) and family.split("::")[-1] in name
