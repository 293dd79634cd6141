"""The port's kernel lab (`cape_tpu_torch.tools.perf_lab`) on the CPU: every
ported subcommand runs end to end at batch 4 and 8 channels on the flagship
context, with the CUDA-event timer replaced by a stub that runs the timed
call once, and prints the JSON lines of the JAX lab with the renamed keys.
The lab itself refuses to run without a GPU and refuses the subcommands
that are not ported."""

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
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck
    from cape_tpu_torch.tools import perf_lab

    timed = []

    def stub(routes):
        for fn in routes.values():
            fn()
            timed.append(1)
        return dict.fromkeys(routes, 1.5)

    monkeypatch.setattr(perf_lab, "time_routes", stub)
    argv, keys, errs = CASES[case]
    before = (ck.launches, ck.fused1_launches, ck.fused_launches, ck.bm_launches)
    perf_lab.main(argv + SMALL)
    assert (ck.launches, ck.fused1_launches, ck.fused_launches, ck.bm_launches) == before
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


@pytest.mark.parametrize("name", ["chain", "parts", "step", "trace", "serve", "http",
                                  "concurrency"])
def test_unported_subcommand_fails_with_its_name(name):
    from cape_tpu_torch.tools import perf_lab

    with pytest.raises(NotImplementedError, match=f"perf_lab {name}: not ported.*ROADMAP"):
        perf_lab.main([name, "--batch", "4"])
