"""The runner of `serve` cells: the program's HTTP server in a child
process (`serve_child.py`), loaded by an open-loop client in this one.

Set-up (`setup_s`): the child's whole start (context, weights, engine,
the server's own warm-up, and on a checkout's first run the kernels'
build), the requests' bodies, and the mix's warm-up requests sent at its
rate. The window: the requests of `--seconds` at the mix's rate, each sent
when due from a pool of client threads, each thread keeping its HTTP/1.1
connection alive as a client session or a gateway does, and timed from
when it was due to the last byte of its response; the client waits up to
the mix's `tail_seconds` past the close for answers still due. The mix's
rate is 0.8 x the knee (the highest swept rate whose p95 stayed within
150 ms with no growing backlog, `sweep.py`). `serve_meshes_per_s`, the
meshes of the window's correct answers over the time from its start to
the last answer, reads the offered load at this rate unless the server
falls behind: the cell guards against that, and cannot show a faster
server. The latencies' 95th percentile (nearest rank, a failed request
missing any limit) spreads too widely from run to run on the card's
host to be judged (PERF.md), and is a per-layer reading.

With --trace 1 the window's counters give decode_fill and decode_call_ms,
then a profiled stretch of `profile_seconds` at the same rate gives the
trace the other readers and `breakdown` read.

The check (`mesh_gap`): once the child has exited, the reference
(`reference.model.sample_mesh`, float32) generates each judged request's
meshes from the seed's weights, the request's pose and clothing and the z
its seed gives, and the widest gap of a served mesh to its reference, over
the reference mesh's largest coordinate, is compared. Every request due
in the window has to be answered (status 200, the meshes' shape, finite).
"""

from __future__ import annotations

import http.client
import io
import json
import os
import queue
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bench_port import common

ASSETS = os.path.join(common.ROOT, "assets")
CLIENT_THREADS = 64
READY_TIMEOUT_S = 900
FAILED_MS = 1e9


class Child:
    """The server process and its command channel."""

    def __init__(self, wl_name: str, seed: int, device: str = "cuda", bench_path=None):
        cmd = [sys.executable, os.path.join(common.BENCH_DIR, "serve_child.py"),
               "--workload", wl_name, "--seed", str(seed), "--device", device]
        if bench_path:
            cmd += ["--bench", bench_path]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     text=True, bufsize=1)
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()
        ready = self._reply(READY_TIMEOUT_S)
        self.port, self.num_verts = ready["ready"], ready["num_verts"]

    def _pump(self):
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def _reply(self, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError("the server process did not answer") from None
            if line is None:
                raise RuntimeError(f"the server process exited ({self.proc.wait()})")
            if line.startswith("{"):
                return json.loads(line)

    def ask(self, cmd: str, timeout: float = 300) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self._reply(timeout)

    def close(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.flush()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class Session:
    """The client threads' HTTP/1.1 connections to the server, one a
    thread, each kept alive from one request to the next (opened again if
    the server closed it)."""

    def __init__(self, port: int):
        self.port = port
        self.local = threading.local()
        self.conns: list[http.client.HTTPConnection] = []

    def post(self, data: bytes) -> tuple[int, bytes]:
        conn = getattr(self.local, "conn", None)
        if conn is None:
            conn = self.local.conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                                timeout=120)
            self.conns.append(conn)
        try:
            conn.request("POST", "/sample", body=data,
                         headers={"Content-Type": "application/x-npz"})
            resp = conn.getresponse()
            out = resp.status, resp.read()
        except Exception:
            conn.close()
            self.local.conn = None
            raise
        if resp.will_close:
            conn.close()
            self.local.conn = None
        return out

    def close(self):
        for conn in self.conns:
            conn.close()


def open_loop(port: int, reqs: list[dict], bodies: list[bytes], num_verts: int,
              keep: set, tail_s: float) -> dict:
    """Send each request when due (an open loop) and wait for the answers,
    up to tail_s past the last one's due time. Returns, per request, its
    latency from due time (inf if it failed or never came), its end time
    and whether it was answered correctly; the kept requests' meshes;
    and the generator's largest lateness."""
    n = len(reqs)
    lat = [float("inf")] * n
    end = [float("inf")] * n
    ok = [False] * n
    meshes = {}
    late = 0.0

    session = Session(port)

    def one(i, t_due):
        status, data = session.post(bodies[i])
        t = time.perf_counter()
        if status != 200:
            return
        disp = np.load(io.BytesIO(data))["disp"]
        if disp.shape == (reqs[i]["n"], num_verts, 3) and np.isfinite(disp).all():
            lat[i], end[i], ok[i] = t - t_due, t, True
            if i in keep:
                meshes[i] = disp

    t0 = time.perf_counter()
    with ThreadPoolExecutor(CLIENT_THREADS) as pool:
        futures = []
        for i, r in enumerate(reqs):
            t_due = t0 + r["due"]
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late = max(late, time.perf_counter() - t_due)
            futures.append(pool.submit(one, i, t_due))
        deadline = t0 + reqs[-1]["due"] + tail_s if reqs else t0
        for f in futures:
            try:
                f.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # a refused or lost request counts as failed
                pass
    session.close()
    return {"t0": t0, "lat": lat, "end": end, "ok": ok, "meshes": meshes, "late_s": late}


def summary(reqs: list[dict], out: dict, seconds: float) -> dict:
    """The window's numbers from open_loop's record: the meshes of every
    correct answer over the time from the window's start to the last of
    them (all the work and all the time it took, so a server that falls
    behind reads less), and the latency quantiles."""
    ends = [e for e, ok in zip(out["end"], out["ok"]) if ok]
    done = sum(r["n"] for r, ok in zip(reqs, out["ok"]) if ok)
    span = max(ends) - out["t0"] if ends else seconds
    # a failed request misses any limit: past a share of 5% failed, p95
    # reads FAILED_MS (such a run is not correct)
    q = lambda p: min(1000.0 * common.quantile(out["lat"], p), FAILED_MS)
    by_size = {}
    for n in sorted({r["n"] for r in reqs}):
        lat = [v for r, v in zip(reqs, out["lat"]) if r["n"] == n]
        by_size[n] = [min(1000.0 * common.quantile(lat, p), FAILED_MS) for p in (0.5, 0.95)]
    return {"p95_ms": q(0.95), "p50_ms": q(0.50),
            "meshes_per_s": done / span, "failed": out["ok"].count(False),
            "late_s": out["late_s"], "by_size_p50_p95_ms": by_size}


def reference_gap(cfgfile: dict, mix: dict, seed: int, reqs, meshes: dict, device,
                  raw: dict, dtype=None) -> float:
    """The widest gap of a judged request's served mesh to the reference's,
    over the reference mesh's largest coordinate (`dtype`: the reference's
    compute dtype, float32 unless a control asks otherwise)."""
    import torch

    from bench_port import weights
    from bench_port.reference import model as ref
    from bench_port.reference.mesh import RefMesh

    dtype = dtype or torch.float32
    gen = common.generator(mix["kind"])
    s = cfgfile["settings"]
    mesh = RefMesh(raw, device)
    P = weights.make(ref.param_spec(s, mesh.level_sizes, mesh.level_sizes_d), seed, device)
    gap = 0.0
    with torch.no_grad():
        for i, served in sorted(meshes.items()):
            r = reqs[i]
            z = torch.as_tensor(gen.latents(r, s["nz"]), device=device)
            pose = torch.as_tensor(r["pose"], device=device).expand(r["n"], -1)
            clo = torch.as_tensor(r["clo"], device=device).expand(r["n"], -1)
            want = ref.sample_mesh(s, P, mesh, z, pose, clo, dtype).float()
            got = torch.as_tensor(served, device=device)
            scale = want.abs().amax(dim=(1, 2))
            gap = max(gap, float(((got - want).abs().amax(dim=(1, 2)) / scale).max()))
    return gap


def run(args, t0, bench, wl, cfgfile, mix, device=None, bench_path=None, raw=None):
    """One run of the cell: (result, checks). `device`, `bench_path` and
    `raw` other than the defaults are for the benchmark's CPU tests."""
    import torch

    from bench_port import flops, roofline, tracing
    from bench_port.reference.mesh import load_raw

    gen = common.generator(mix["kind"])
    dev = device or "cuda"
    child = Child(wl["name"], args.seed, dev, bench_path)
    try:
        num_verts = child.num_verts
        warm = gen.requests(mix, args.seed, mix["warmup_requests"] / mix["rate"], stream=0)
        window = gen.requests(mix, args.seed, args.seconds, stream=1)
        keep = set(gen.judged(mix, args.seed, window))
        bodies = [gen.body(r) for r in window]
        open_loop(child.port, warm, [gen.body(r) for r in warm], num_verts, set(),
                  mix["tail_seconds"])
        child.ask("mark")
        setup_s = time.perf_counter() - t0
        out = open_loop(child.port, window, bodies, num_verts, keep, mix["tail_seconds"])
        stats = child.ask("stats")
        s = summary(window, out, args.seconds)
        m, breakdown = {}, None
        if args.trace:
            prof_reqs = gen.requests(mix, args.seed, mix["profile_seconds"], stream=2)
            child.ask("trace_start")
            open_loop(child.port, prof_reqs, [gen.body(r) for r in prof_reqs], num_verts, set(),
                      mix["tail_seconds"])
            traced = child.ask("trace_stop", timeout=600)
            events = tracing.load(traced["trace"])
            m = {"kind": "serve", "trace_events": events,
                 "launch_bounds": traced["launch_bounds"]}
            breakdown = tracing.breakdown(events)
    finally:
        child.close()

    print(f"window: {len(window)} requests, p50 {s['p50_ms']:.3f} ms, p95 {s['p95_ms']:.3f} ms, "
          f"failed {s['failed']}, generator late by up to {1000 * s['late_s']:.3f} ms, "
          f"decode calls {stats['decode_calls']}, by size (p50, p95 ms) "
          f"{json.dumps(s['by_size_p50_p95_ms'])}", file=sys.stderr)
    e2e, per = common.cell_metrics(bench, wl["name"])
    cuda = dev.startswith("cuda")
    device_t = torch.device(dev)
    raw = raw if raw is not None else load_raw(ASSETS)
    gap = reference_gap(cfgfile, mix, args.seed, window, out["meshes"], device_t, raw)
    missing = len(keep) - len(out["meshes"])
    limits = mix["limits"]
    checks = {"mesh_gap": {"value": gap, "limit": limits["mesh_gap"]},
              "failed": {"value": s["failed"], "limit": limits["failed"]}}
    result = {"correct": gap <= limits["mesh_gap"] and s["failed"] <= limits["failed"]
              and missing == 0,
              "attempted": len(window), "failed": s["failed"],
              "forbidden": stats["forbidden"]}
    device_info = {"platform": "gpu" if cuda else dev, "kind": stats["kind"], "count": 1,
                   "memory_peak_bytes": stats["memory_peak_bytes"]}
    if cuda:
        device_info["power"] = common.power_limit()
    if args.trace:
        counter = flops.Counter(cfgfile["settings"], raw)
        m.update({k: stats[k] for k in ("decode_calls", "decode_rows", "decode_s", "batch_size")},
                 p95_ms=s["p95_ms"],
                 decode_call_ops=counter.decode_call(stats["batch_size"]),
                 peak_flops=roofline.PEAK_FLOP_PER_S[mix["compute_dtype"]])
        result["metrics"] = common.read_per_layer(per, m)
        device_info.update(tracing.device_fields(m["trace_events"]))
        result["breakdown"] = breakdown
    else:
        values = {"setup_s": setup_s, "serve_meshes_per_s": s["meshes_per_s"]}
        result["metrics"] = {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
                             for e in e2e}
    result["device"] = device_info
    return result, checks
