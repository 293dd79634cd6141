"""The serve cell's server process: the program's HTTP server over its
engine, on 127.0.0.1 at a free port, driven by commands on standard input.

    python bench_port/serve_child.py --workload <name> --seed <n> [--device cuda]

It builds the configuration's model with the benchmark's weights from the
seed (`weights`, loaded through the state-dict path), the engine at the
mix's batch, wraps the engine's decode stage in the benchmark's timer,
serves it with `serve(engine, port=0)` (micro-batched), runs the server's
own warm-up, and prints `READY <port>`. Then each line on standard input
is a command, answered by one JSON line on standard output:

  mark         start the window's counters
  stats        the window's decode calls, rows and seconds, the device's
               peak memory and name, and JAX's modules if any were loaded
  trace_start  start the profiler and the kernel-launch recorder
  trace_stop   stop both; write the trace under the checkout; its path
               and each launch's frozen bound
  quit         stop serving and exit
"""

import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class DecodeTimer:
    """The engine's decode stage, timed on the host clock (the call is
    synchronous: it reads its output back) and its rows counted, while on."""

    def __init__(self, engine):
        self.orig = engine.decode
        self.on = False
        self.s = 0.0
        self.rows = 0
        engine.decode = self

    def __call__(self, z_total, y, y2):
        t = time.perf_counter()
        out = self.orig(z_total, y, y2)
        if self.on:
            self.s += time.perf_counter() - t
            self.rows += len(z_total)
        return out


def build(wl_name: str, seed: int, device, bench=None):
    """(engine, cfg) of the serve cell `wl_name` with the seed's weights."""
    import torch

    from bench_port import common, program, weights
    from bench_port.reference import model as ref

    bench = bench or common.benchmark()
    wl = common.workload(bench, wl_name)
    cfgfile = common.config_file(bench, wl["config"])
    mix = common.traffic_file(wl["traffic"])
    cfg = program.config(cfgfile["settings"], name=wl_name, seed=seed,
                         batch_size=mix["batch_size"], compute_dtype=mix["compute_dtype"],
                         **cfgfile["overrides"])
    mesh = program.toy_mesh(cfgfile["toy_mesh"], cfg) if cfgfile.get("toy_mesh") else None
    ctx = program.context(cfg, device, mesh)
    perm0, perm_last = program.level_perms(cfg, mesh)
    spec = ref.param_spec(cfgfile["settings"], list(ctx.level_sizes), list(ctx.level_sizes_d))
    w = weights.port_layout(weights.make(spec, seed, device),
                            torch.as_tensor(perm0, device=device),
                            torch.as_tensor(perm_last, device=device))
    return program.engine(cfg, program.model(cfg, w), ctx, device), cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=None, help="a BENCHMARK.json other than the checkout's")
    args = p.parse_args(argv)

    from bench_port import common

    common.pin(common.PROGRAM_CORES)
    import torch

    from bench_port import program, tracing
    from cape_tpu_torch.apps.server import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    bench = common.load_json(args.bench) if args.bench else None
    engine, cfg = build(args.workload, args.seed, device, bench)
    timer = DecodeTimer(engine)
    httpd, ms = serve(engine, "127.0.0.1", 0)
    ms.warmup()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    say = lambda obj: print(json.dumps(obj), flush=True)
    say({"ready": httpd.server_address[1], "num_verts": int(engine.ctx.level_sizes[0])})

    calls0, prof, recorder = 0, None, None
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "mark":
            calls0 = engine.calls["decode"]
            timer.on, timer.s, timer.rows = True, 0.0, 0
            say({"ok": True})
        elif cmd == "stats":
            timer.on = False
            say({"decode_calls": engine.calls["decode"] - calls0, "decode_rows": timer.rows,
                 "decode_s": timer.s, "batch_size": engine.batch_size,
                 "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
                 "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                 "forbidden": common.forbidden_modules()})
        elif cmd == "trace_start":
            recorder = program.LaunchRecorder().__enter__()
            prof = tracing.profiler()
            prof.start()
            say({"ok": True})
        elif cmd == "trace_stop":
            if cuda:
                torch.cuda.synchronize(device)
            prof.stop()
            recorder.__exit__(None, None, None)
            path = os.path.join(common.WORK_DIR, f"{args.workload}.json")
            tracing.export(prof, path)
            say({"trace": path, "launch_bounds": tracing.launch_bounds(recorder.records)})
        elif cmd == "quit":
            break
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
