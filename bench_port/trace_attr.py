"""Attribution of a torch.profiler Chrome trace: each device event's
category, kernel family and launching host operator.

Frozen copy of `cape_tpu_torch/tools/perf_lab.py` lines 665-812 as they
stood when the benchmark was written (`PORT_KERNELS` and the category
tables, `category`, `kernel_family`, `_frame`, `_sweep`, `attribute`),
unchanged but for this docstring, so that the program's own lab can change
without moving the benchmark's readings.
"""

from __future__ import annotations

# kernel-name fragments of the port's CUDA kernels (cape_tpu_torch/csrc/)
PORT_KERNELS = ("band_gather_kernel", "cheb2_fused_kernel", "cheb2_window_kernel")
_GEMM = ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas", "splitkreduce",
         "aten::mm", "aten::bmm", "aten::addmm", "aten::matmul", "aten::linear", "aten::einsum")
_COPY = ("copy", "memset", "memcpy", "fill", "aten::cat", "aten::clone", "aten::contiguous",
         "aten::constant_pad_nd", "aten::zero_", "aten::index_select", "aten::stack")
_REDUCE = ("reduce", "norm", "softmax", "aten::sum", "aten::mean", "aten::max", "aten::min",
           "aten::amax", "aten::var", "aten::std", "aten::logsumexp")
_ELEMENTWISE = ("elementwise", "aten::add", "aten::sub", "aten::mul", "aten::div",
                "aten::leaky_relu", "aten::relu", "aten::where", "aten::abs", "aten::neg",
                "aten::exp", "aten::log", "aten::pow", "aten::sqrt", "aten::rsqrt",
                "aten::tanh", "aten::sigmoid", "aten::clamp", "aten::threshold_backward",
                "aten::sgn", "aten::lerp", "aten::maximum", "aten::minimum", "aten::gt",
                "aten::lt", "aten::ge", "aten::le", "aten::eq")


def category(name: str, cat: str = "kernel") -> str:
    """The trace's category of a device kernel (by its name and trace
    category) or, on the CPU, of an aten operator, first match wins:
      port kernel  the port's CUDA kernels (`PORT_KERNELS`);
      copy/memset  memcpy and memset events, copy and fill kernels; on the
                   CPU cat, clone, pad, index_select, zero_;
      gemm         cuBLAS and CUTLASS kernels (gemm, gemv, cutlass, xmma,
                   nvjet, splitKreduce); on the CPU mm, bmm, addmm, matmul,
                   einsum;
      reduction    reduce kernels, norms, softmax; on the CPU sum, mean, ...;
      elementwise  PyTorch's elementwise kernels; on the CPU the pointwise
                   arithmetic operators;
      other        the rest (indexing, scatter, sort, views ...)."""
    n = name.lower()
    if any(s in n for s in PORT_KERNELS):
        return "port kernel"
    if cat in ("gpu_memcpy", "gpu_memset") or any(s in n for s in _COPY):
        return "copy/memset"
    for label, keys in (("gemm", _GEMM), ("reduction", _REDUCE), ("elementwise", _ELEMENTWISE)):
        if any(s in n for s in keys):
            return label
    return "other"


def kernel_family(name: str) -> str:
    """A kernel's name without its template arguments, argument list,
    leading `void` and anonymous namespaces."""
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    out, depth = [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


def _frame(name: str) -> str | None:
    """A python_function event's frame, from `cape_tpu_torch/` on; None
    for a frame outside the port."""
    i = name.find("cape_tpu_torch/")
    return None if i < 0 else name[i:]


def _sweep(events: list) -> dict:
    """One pass over a thread's X events in time order. For every cpu_op
    and cuda_runtime/cuda_driver event: the innermost enclosing cpu_op
    (name) and the innermost enclosing python frame under cape_tpu_torch/.
    For every cpu_op also its self time (its duration less its direct
    child operators'). Returns id(event) -> [operator, frame, self_us]."""
    out = {}
    stack: list = []   # open (end, event) of python frames and operators
    for e in sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0))):
        while stack and stack[-1][0] <= e["ts"]:
            stack.pop()
        cat = e.get("cat")
        if cat != "python_function":
            op = next((s for _, s in reversed(stack) if s.get("cat") == "cpu_op"), None)
            frame = next((f for f in (_frame(s["name"]) for _, s in reversed(stack)
                                      if s.get("cat") == "python_function") if f), None)
            out[id(e)] = [op["name"] if op else None, frame, e.get("dur", 0)]
            if cat == "cpu_op" and op is not None:
                out[id(op)][2] -= e.get("dur", 0)
        if cat in ("cpu_op", "python_function"):
            stack.append((e["ts"] + e.get("dur", 0), e))
    return out


def attribute(events: list, n_steps: int, top: int = 20, device_time: bool = True) -> dict:
    """Attribution of a torch.profiler Chrome trace's events (`traceEvents`)
    over n_steps steps. device_time=True: every device event (cat kernel,
    gpu_memcpy, gpu_memset) with its device duration; each is linked by its
    `correlation` to the cudaLaunchKernel (or driver) call that issued it,
    and from there to the innermost aten operator and the innermost
    cape_tpu_torch frame enclosing that call on its host thread (a kernel
    launched from Python through ctypes has no operator: "-"). False (a
    CPU-only trace): every cpu_op with its self time. Returns
      ms_per_step, events_per_step,
      by_category: [(category, us/step, count/step)], by total time;
      by_operator: [(operator, frame, us/step, count/step)], top `top`;
      by_kernel:   [(kernel_family, operator, us/step, count/step)], top `top`;
      family_counts: {kernel_family: count/step}, every family.
    No byte or operation counts: the trace carries none, so no rates."""
    import collections

    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    threads = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") in ("cpu_op", "python_function", "cuda_runtime", "cuda_driver"):
            threads[(e.get("pid"), e.get("tid"))].append(e)
    where = {}
    for evs in threads.values():
        where.update(_sweep(evs))
    if device_time:
        launch = {e["args"]["correlation"]: where[id(e)] for e in xs
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        units = []
        for e in xs:
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                op, frame, _ = launch.get(e.get("args", {}).get("correlation"), (None, None, 0))
                units.append((e["name"], e.get("cat"), op, frame, e.get("dur", 0)))
    else:
        units = [(e["name"], "cpu_op", e["name"], where[id(e)][1], where[id(e)][2])
                 for e in xs if e.get("cat") == "cpu_op"]
    by_cat = collections.defaultdict(lambda: [0.0, 0])
    by_op = collections.defaultdict(lambda: [0.0, 0])
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    families = collections.Counter()
    for name, cat, op, frame, us in units:
        for table, key in ((by_cat, category(name, cat)), (by_op, (op or "-", frame or "-")),
                           (by_kernel, (kernel_family(name), op or "-"))):
            table[key][0] += us
            table[key][1] += 1
        families[kernel_family(name)] += 1
    rank = lambda table, n=None: sorted(table.items(), key=lambda kv: -kv[1][0])[:n]
    per = lambda v: (v[0] / n_steps, v[1] / n_steps)
    return {
        "ms_per_step": sum(u[-1] for u in units) / 1000.0 / n_steps,
        "events_per_step": len(units) / n_steps,
        "by_category": [(k, *per(v)) for k, v in rank(by_cat)],
        "by_operator": [(*k, *per(v)) for k, v in rank(by_op, top)],
        "by_kernel": [(*k, *per(v)) for k, v in rank(by_kernel, top)],
        "family_counts": {k: v / n_steps for k, v in families.items()},
    }
