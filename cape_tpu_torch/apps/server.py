"""HTTP model server: the JSON / npz wire API of `cape_tpu.apps.server`
over the PyTorch `InferenceEngine`.

  python -m cape_tpu_torch.apps.server --config configs/<preset>.yaml \
      --name run1 [--fresh-init] [--batch_size 32] [--device cpu] [--port 0] \
      [--no-micro-batch] [--no-warmup]
  python -m cape_tpu_torch.apps.server --artifact model.capex [--device cpu] ...

With --artifact it serves an AOT export (`tools.export_model`) through
`ExportedEngine` instead: no config, checkpoint or model-building code.

It runs on the GPU; without one it raises unless `--device cpu` asks for
the CPU. With nz == 18 (the nz18 presets) it loads the shipped GMM prior
for /sample prior="gmm".

Endpoints (arrays are nested JSON lists, float32 on the wire; POST an
`np.savez` archive with `Content-Type: application/x-npz` and/or send
`Accept: application/x-npz` for binary arrays; errors are always JSON):
  GET  /health       -> model identity, dims, batch size
  GET  /stats        -> per-endpoint request counts + latency quantiles,
                        and the micro-batchers' counts under "(micro_batch)"
  GET  /metrics      -> the same numbers as Prometheus text (format 0.0.4)
  GET  /viewer       -> the live WebGL page (template mesh embedded, wired
                        to POST /sample); 404 for a non-template mesh
  POST /encode       {disp [N,V,3], pose [N,cond_dim], clo [N,cond2_dim]}
                     -> {z_mean, z_logvar, y, y2}
  POST /decode       {z [N,nz], pose, clo} or {z_total, y, y2} -> {disp}
  POST /reconstruct  {disp, pose, clo, sample?: bool, seed?: int} -> {disp}
  POST /sample       {pose [1|N,..], clo [1|N,..], n?: int, seed?: int,
                      prior?: "normal"|"gmm"} -> {disp, z}

Concurrency: the HTTP layer is threaded and device work goes through one
lock. By default (dynamic micro-batching, as the JAX server) concurrent
/sample, /decode, /encode and deterministic /reconstruct requests
coalesce: the embed, encode and decode stages each have a worker thread
that gathers up to batch_size rows across requests, waiting at most 2 ms
after the first, into one padded device call. Per-row math does not
depend on the batch, so a coalesced response equals the per-request
one. /reconstruct sample=true stays per request. `--no-micro-batch` runs
one request at a time behind the lock. A device error inside a batcher
reaches every request of its call as a 500.

SIGTERM or SIGINT drains: the server stops accepting, responses carry
`Connection: close`, and it exits once every request in flight has been
answered (30 s at most).

`--data_parallel N` (N > 1) serves over N local devices of `--device`'s
kind, for bulk throughput, as the JAX server shards its mesh: the engine
holds a replica per device, batch_size rows on each (apps.inference). More
devices than there are raises before anything is built.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from cape_tpu_torch.apps.inference import InferenceEngine, broadcast_conditions

NPZ_CONTENT_TYPE = "application/x-npz"


class ServerError(ValueError):
    """Client-visible request error (becomes a 400 with the message)."""


def _npz_to_body(raw: bytes) -> dict:
    """Decode an npz request body: arrays stay arrays, 0-d entries become
    python scalars (n, seed, sample, ...)."""
    try:
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            return {k: (v.item() if v.ndim == 0 else v) for k, v in z.items()}
    except Exception as e:
        raise ValueError(str(e)) from None


def _body_to_npz(payload: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


class _MicroBatcher:
    """Dynamic request coalescing: rows from concurrent requests merge
    into one fixed-batch device call. A worker drains the queue up to
    `capacity` rows, waiting at most `window_ms` after the first arrival.
    `fn` receives row-stacked arrays and returns row-stacked outputs;
    per-row math must not depend on the batch (every model reduction is
    per sample). An exception of `fn` reaches every waiting future."""

    def __init__(self, fn, capacity: int, window_ms: float = 2.0, name: str = ""):
        self.fn = fn
        self.capacity = max(1, capacity)
        self.window = window_ms / 1000.0
        self.calls = 0          # device calls issued (see /stats)
        self.requests = 0       # submissions coalesced into them
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True, name=f"microbatch-{name}")
        self._thread.start()

    def submit(self, arrays) -> Future:
        """arrays: per-argument [n, ...] rows. Returns a Future resolving
        to the tuple of this request's output rows."""
        f = Future()
        self._q.put((arrays, f))
        return f

    def _run(self):
        while True:
            batch = [self._q.get()]
            rows = len(batch[0][0][0])
            deadline = time.monotonic() + self.window
            while rows < self.capacity:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                batch.append(nxt)
                rows += len(nxt[0][0])
            try:
                args = [np.concatenate([b[0][i] for b in batch]) for i in range(len(batch[0][0]))]
                out = self.fn(*args)
                out = out if isinstance(out, tuple) else (out,)
                self.calls += 1
                self.requests += len(batch)
                off = 0
                for arrays, fut in batch:
                    n = len(arrays[0])
                    fut.set_result(tuple(o[off : off + n] for o in out))
                    off += n
            except Exception as e:  # deliver to every waiting request
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


def _as_array(obj, name: str, ndim: int, last_dim: int | None = None) -> np.ndarray:
    if obj is None:
        raise ServerError(f"missing required field {name!r}")
    try:
        arr = np.asarray(obj, np.float32)
    except (TypeError, ValueError) as e:
        raise ServerError(f"field {name!r} is not a numeric array: {e}") from None
    if arr.ndim != ndim:
        raise ServerError(f"field {name!r} must have {ndim} dims, got {arr.ndim}")
    if last_dim is not None and arr.shape[-1] != last_dim:
        raise ServerError(f"field {name!r} last dim must be {last_dim}, got {arr.shape[-1]}")
    if arr.shape[0] == 0:
        raise ServerError(f"field {name!r} has zero rows")
    if not np.isfinite(arr).all():
        raise ServerError(f"field {name!r} contains non-finite values")
    return arr


def _as_int(body: dict, name: str, default: int, min_value: int | None = None) -> int:
    v = body.get(name, default)
    try:
        if isinstance(v, bool) or not isinstance(v, (int, float)) or int(v) != v:
            raise ValueError
    except (ValueError, OverflowError):
        raise ServerError(f"field {name!r} must be an integer, got {v!r}") from None
    v = int(v)
    if min_value is not None and v < min_value:
        raise ServerError(f"field {name!r} must be >= {min_value}, got {v}")
    return v


class _Stats:
    """Per-endpoint request counter + latency ring (median/p95 over the
    last `window` requests)."""

    def __init__(self, window: int = 256):
        self.window = window
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._errors: dict[str, int] = {}
        self._lat: dict[str, list[float]] = {}

    def record(self, endpoint: str, ms: float, ok: bool) -> None:
        with self._lock:
            self._counts[endpoint] = self._counts.get(endpoint, 0) + 1
            if not ok:
                self._errors[endpoint] = self._errors.get(endpoint, 0) + 1
            ring = self._lat.setdefault(endpoint, [])
            ring.append(ms)
            if len(ring) > self.window:
                del ring[: len(ring) - self.window]

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for ep, n in sorted(self._counts.items()):
                lat = sorted(self._lat.get(ep, []))
                # nearest-rank quantile: ceil(p*n)-1
                q = lambda p: round(lat[max(0, -(-int(p * 100 * len(lat)) // 100) - 1)], 3)
                out[ep] = {
                    "requests": n,
                    "errors": self._errors.get(ep, 0),
                    "latency_ms_p50": q(0.50) if lat else None,
                    "latency_ms_p95": q(0.95) if lat else None,
                }
            return out


class _RequestSpan:
    """One in-flight request, for ModelServer.drain."""

    __slots__ = ("ms",)

    def __init__(self, ms):
        self.ms = ms

    def __enter__(self):
        with self.ms._inflight_cv:
            self.ms._inflight += 1
        return self

    def __exit__(self, *exc):
        with self.ms._inflight_cv:
            self.ms._inflight -= 1
            self.ms._inflight_cv.notify_all()
        return False


class ModelServer:
    """Request handling around one InferenceEngine; transport lives in
    `serve()` so tests can call handle() directly too."""

    def __init__(self, engine: InferenceEngine, gmm=None, micro_batch: bool = True,
                 viewer_mesh: tuple | None = None):
        self.engine = engine
        # (faces, mean, std, demo_poses) for GET /viewer; None = the shipped
        # template assets for a 6890-vertex model (else 404). The page is
        # built at its first request.
        self._viewer_mesh = viewer_mesh
        self._viewer_page: bytes | None = None
        self.gmm = gmm  # models.gmm.GMM for /sample prior="gmm" (host arrays)
        self.stats = _Stats()
        self._device_lock = threading.Lock()
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self.draining = False  # set at shutdown: responses add Connection: close
        self._embed_b = self._decode_b = self._encode_b = None
        if micro_batch:
            bs = engine.batch_size
            self._embed_b = _MicroBatcher(self._locked(engine.encode_only_condition), bs,
                                          name="embed")
            self._decode_b = _MicroBatcher(self._locked(engine.decode), bs, name="decode")
            self._encode_b = _MicroBatcher(self._locked(engine.encode), bs, name="encode")
        cfg = engine.model.cfg
        self.info = {
            "status": "ok",
            "model": cfg.name,
            "num_verts": int(engine.ctx.level_sizes[0]),
            "nz": cfg.nz,
            "nz_cond": cfg.nz_cond,
            "nz_cond2": cfg.nz_cond2,
            "cond_dim": cfg.cond_dim,
            "cond2_dim": cfg.cond2_dim,
            "batch_size": engine.batch_size,
            "compute_dtype": cfg.compute_dtype,
            "gmm_prior": gmm is not None,
            "device": str(engine.device),
        }

    def viewer_html(self) -> bytes:
        """The GET /viewer page: the WebGL renderer with this model's
        template mesh embedded and controls wired to POST /sample. Raises
        ServerError when no mesh topology is known (the transport answers
        404)."""
        if self._viewer_page is not None:
            return self._viewer_page
        from cape_tpu_torch.meshops.viewer import live_viewer_html

        cfg = self.engine.model.cfg
        # the live engine carries the (device-order) template; an artifact
        # engine ships no topology (its duck-typed ctx has neither the
        # template nor the natural-order mapping): the template then comes
        # from assets/ for the SMPL topology, else a 404
        template = None
        tv = getattr(self.engine.ctx, "template_verts", None)
        if tv is not None and hasattr(self.engine, "_to_natural_order"):
            tv = tv.detach().cpu().numpy().astype(np.float32)
            template = self.engine._to_natural_order(tv[None])[0]
        if self._viewer_mesh is not None:
            faces, mean, std, demo_poses = self._viewer_mesh
        elif self.info["num_verts"] == 6890:
            # the SMPL template topology: everything ships in assets/
            from cape_tpu_torch.meshops import assets
            from cape_tpu_torch.smpl.joints import filter_cloth_pose

            averts, faces = assets.template_mesh()
            if template is None:
                template = np.asarray(averts, np.float32)  # natural order
            mean, std = assets.trainset_stats()
            poses = assets.demo_pose_params()
            raw = poses["rot"] if cfg.cond_dim % 9 == 0 else poses["pose"]
            demo_poses = filter_cloth_pose(raw) if raw.shape[-1] != cfg.cond_dim else raw
        else:
            raise ServerError(
                "no mesh topology known for this model — pass viewer_mesh="
                "(faces, mean, std, demo_poses) to ModelServer/serve()"
            )
        if template is None:
            raise ServerError(
                "this engine ships no mesh template (an artifact of a model that is not "
                "on the SMPL topology): /viewer needs a live engine or the SMPL topology"
            )
        if demo_poses is None or np.asarray(demo_poses).size == 0:
            demo_poses = np.zeros((1, cfg.cond_dim), np.float32)
        demo_poses = np.asarray(demo_poses, np.float32)
        if demo_poses.ndim == 1:
            demo_poses = demo_poses[None]
        if demo_poses.shape[-1] != cfg.cond_dim:
            raise ServerError(
                f"viewer demo poses are {demo_poses.shape[-1]}-dim but the "
                f"model conditions on {cfg.cond_dim}"
            )
        # the JAX server's title, so both packages serve the same page
        self._viewer_page = live_viewer_html(
            template, faces, demo_poses, cfg.cond2_dim,
            has_gmm=self.gmm is not None, mean=mean, std=std,
            title=f"cape_tpu live viewer — {cfg.name}",
        ).encode()
        return self._viewer_page

    def warmup(self) -> float:
        """Run every stage once (and build the CUDA kernels on a GPU) so the
        first request pays no set-up. Returns elapsed seconds."""
        t0 = time.perf_counter()
        cfg = self.engine.model.cfg
        disp = np.zeros((1, self.info["num_verts"], 3), np.float32)
        pose = np.zeros((1, cfg.cond_dim), np.float32)
        clo = np.zeros((1, cfg.cond2_dim), np.float32)
        with self._device_lock:
            self.engine.autoencode(disp, pose, clo, sample=True)
            # the artifact engine's embed is a program of its own, not
            # reached through autoencode's encode
            self.engine.encode_only_condition(pose, clo)
        return time.perf_counter() - t0

    def _locked(self, fn):
        def call(*args):
            with self._device_lock:
                return fn(*args)

        return call

    def track_request(self) -> _RequestSpan:
        """Context manager the transport wraps around each request, from
        parsing to the last response byte, for drain()."""
        return _RequestSpan(self)

    def drain(self, timeout: float = 30.0, grace: float = 0.25) -> bool:
        """Block until every in-flight request has been answered, or the
        timeout passes (then False). Call after setting `draining`
        (responses then close their connections, and the stopped accept
        loop admits none). The grace re-check catches a request whose bytes
        arrived just before the count reached zero. Idle keep-alive
        connections do not count."""
        deadline = time.monotonic() + timeout
        while True:
            with self._inflight_cv:
                while self._inflight > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._inflight_cv.wait(remaining)
            time.sleep(grace)
            with self._inflight_cv:
                if self._inflight == 0:
                    return True

    def batcher_counts(self) -> dict | None:
        """The micro-batchers' device calls and coalesced requests per
        stage (the "(micro_batch)" block of /stats); None without them."""
        if self._decode_b is None:
            return None
        out = {}
        for stage, b in (("embed", self._embed_b), ("encode", self._encode_b),
                         ("decode", self._decode_b)):
            out[f"{stage}_calls"] = b.calls
            out[f"{stage}_requests"] = b.requests
        return out

    def metrics_text(self) -> str:
        """Prometheus text exposition (version 0.0.4) of the numbers /stats
        reports: request and error counters, latency quantiles over the
        ring window, the micro-batch counters, and one cape_model_info
        gauge with the model's identity (the JAX server's names)."""
        esc = (
            lambda s: str(s)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")  # exposition format 0.0.4 label escaping
        )
        lines = [
            "# TYPE cape_requests_total counter",
            "# TYPE cape_request_errors_total counter",
            "# TYPE cape_request_latency_ms summary",
            "# TYPE cape_microbatch_requests_total counter",
            "# TYPE cape_microbatch_device_calls_total counter",
            "# TYPE cape_model_info gauge",
        ]
        info = self.info
        lines.append(
            'cape_model_info{model="%s",batch_size="%s",compute_dtype="%s"} 1'
            % (esc(info["model"]), info["batch_size"], esc(info["compute_dtype"]))
        )
        for ep, row in self.stats.snapshot().items():
            label = f'endpoint="{esc(ep)}"'
            lines.append("cape_requests_total{%s} %d" % (label, row["requests"]))
            lines.append("cape_request_errors_total{%s} %d" % (label, row["errors"]))
            for q, key in (("0.5", "latency_ms_p50"), ("0.95", "latency_ms_p95")):
                if row[key] is not None:
                    lines.append('cape_request_latency_ms{%s,quantile="%s"} %s'
                                 % (label, q, row[key]))
        counts = self.batcher_counts()
        if counts is not None:
            for stage in ("embed", "encode", "decode"):
                lines.append('cape_microbatch_requests_total{stage="%s"} %d'
                             % (stage, counts[f"{stage}_requests"]))
                lines.append('cape_microbatch_device_calls_total{stage="%s"} %d'
                             % (stage, counts[f"{stage}_calls"]))
        return "\n".join(lines) + "\n"

    def _embed_then_decode(self, z: np.ndarray, pose: np.ndarray, clo: np.ndarray):
        """The generation path of /sample and /decode-with-z: pose/clo may
        have 1 row for n z-rows; the condition net runs on the unique rows
        and the embedding broadcasts host-side."""
        if self._embed_b is not None:
            y, y2 = self._embed_b.submit([pose, clo]).result()
        else:
            with self._device_lock:
                y, y2 = self.engine.encode_only_condition(pose, clo)
        y, y2 = broadcast_conditions(y, y2, len(z))
        return self._decode(np.concatenate([z, y, y2], axis=-1), y, y2)

    # each stage through its micro-batcher when enabled, else behind the lock
    def _encode(self, disp, pose, clo):
        if self._encode_b is not None:
            return self._encode_b.submit([disp, pose, clo]).result()
        with self._device_lock:
            return self.engine.encode(disp, pose, clo)

    def _decode(self, zt, y, y2):
        if self._decode_b is not None:
            y, y2 = broadcast_conditions(y, y2, len(zt))  # a batcher's rows must align
            return self._decode_b.submit([zt, y, y2]).result()[0]
        with self._device_lock:
            return self.engine.decode(zt, y, y2)

    # ----------------------------------------------------------- handlers
    def _conditions(self, body: dict, n: int | None = None):
        cfg = self.engine.model.cfg
        pose = _as_array(body.get("pose"), "pose", 2, cfg.cond_dim)
        clo = _as_array(body.get("clo"), "clo", 2, cfg.cond2_dim)
        if n is not None:
            if pose.shape[0] not in (1, n) or clo.shape[0] not in (1, n):
                raise ServerError(
                    f"pose/clo rows ({pose.shape[0]}/{clo.shape[0]}) must be 1 or n={n}"
                )
            r = max(pose.shape[0], clo.shape[0])
            if pose.shape[0] != r:
                pose = np.repeat(pose, r, axis=0)
            if clo.shape[0] != r:
                clo = np.repeat(clo, r, axis=0)
        elif pose.shape[0] != clo.shape[0]:
            raise ServerError("pose and clo must have the same number of rows")
        return pose, clo

    def _disp(self, body: dict) -> np.ndarray:
        v = self.info["num_verts"]
        disp = _as_array(body.get("disp"), "disp", 3, 3)
        if disp.shape[1] != v:
            raise ServerError(f"disp must be [N,{v},3], got {list(disp.shape)}")
        return disp

    def handle_encode(self, body: dict) -> dict:
        disp = self._disp(body)
        pose, clo = self._conditions(body)
        if pose.shape[0] != disp.shape[0]:
            raise ServerError("disp and pose must have the same number of rows")
        z_mean, z_logvar, y, y2 = self._encode(disp, pose, clo)
        return {"z_mean": z_mean, "z_logvar": z_logvar, "y": y, "y2": y2}

    def handle_decode(self, body: dict) -> dict:
        cfg = self.engine.model.cfg
        if "z_total" in body:  # pre-embedded fast path (skip condition nets)
            zt = _as_array(body["z_total"], "z_total", 2, cfg.z_total_dim)
            y = _as_array(body.get("y"), "y", 2, cfg.nz_cond)
            y2 = _as_array(body.get("y2"), "y2", 2, cfg.nz_cond2)
            n = zt.shape[0]
            if y.shape[0] not in (1, n) or y2.shape[0] not in (1, n):
                raise ServerError(
                    f"y/y2 rows ({y.shape[0]}/{y2.shape[0]}) must be 1 or "
                    f"match z_total rows ({n})"
                )
            return {"disp": self._decode(zt, y, y2)}
        z = _as_array(body.get("z"), "z", 2, cfg.nz)
        pose, clo = self._conditions(body, n=z.shape[0])
        return {"disp": self._embed_then_decode(z, pose, clo)}

    def handle_reconstruct(self, body: dict) -> dict:
        disp = self._disp(body)
        pose, clo = self._conditions(body)
        if pose.shape[0] != disp.shape[0]:
            raise ServerError("disp and pose must have the same number of rows")
        sample = bool(body.get("sample", False))
        seed = _as_int(body, "seed", 0, min_value=0)
        if sample:
            # per request: its rows are keyed by its own seed
            with self._device_lock:
                return {"disp": self.engine.autoencode(disp, pose, clo, rng=seed, sample=True)}
        # the deterministic path (z = posterior mean) is /encode then /decode
        z_mean, _, y, y2 = self._encode(disp, pose, clo)
        return {"disp": self._decode(np.concatenate([z_mean, y, y2], axis=-1), y, y2)}

    def handle_sample(self, body: dict) -> dict:
        cfg = self.engine.model.cfg
        n = _as_int(body, "n", 1)
        if not 1 <= n <= 1024:
            raise ServerError("n must be in [1, 1024]")
        pose, clo = self._conditions(body, n=n)
        prior = body.get("prior", "normal")
        seed = _as_int(body, "seed", 0, min_value=0)
        # the JAX server's host draws, so one seed gives one z there and here
        if prior == "gmm":
            if self.gmm is None:
                raise ServerError("no GMM prior loaded on this server")
            z = self.gmm.sample_np(np.random.default_rng(seed), n)
            if z.shape[1] != cfg.nz:
                raise ServerError(f"GMM prior is {z.shape[1]}-dim but model nz={cfg.nz}")
        elif prior == "normal":
            z = np.random.default_rng(seed).standard_normal((n, cfg.nz)).astype(np.float32)
        else:
            raise ServerError(f"unknown prior {prior!r} (use 'normal' or 'gmm')")
        return {"disp": self._embed_then_decode(z, pose, clo), "z": z}

    # ------------------------------------------------------------ routing
    _POST = {
        "/encode": handle_encode,
        "/decode": handle_decode,
        "/reconstruct": handle_reconstruct,
        "/sample": handle_sample,
    }

    def handle(self, method: str, path: str, body: dict | None, raw: bool = False):
        """(method, path, parsed body) -> (http status, response dict).
        raw=True leaves arrays as numpy (binary npz responses)."""
        t0 = time.perf_counter()
        ok = True
        ep = f"{method} {path}"
        try:
            if method == "GET" and path == "/health":
                return 200, dict(self.info)
            if method == "GET" and path == "/stats":
                snap = self.stats.snapshot()
                counts = self.batcher_counts()
                if counts is not None:
                    snap["(micro_batch)"] = counts
                return 200, snap
            fn = self._POST.get(path) if method == "POST" else None
            if fn is None:
                ok = False
                ep = "(unrouted)"
                return 404, {"error": f"no route {method} {path}"}
            out = fn(self, body or {})
            if raw:
                return 200, out
            return 200, {
                k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in out.items()
            }
        except ServerError as e:
            ok = False
            return 400, {"error": str(e)}
        except Exception as e:  # surface, don't kill the server thread
            ok = False
            return 500, {"error": f"{type(e).__name__}: {e}"}
        finally:
            self.stats.record(ep, 1000.0 * (time.perf_counter() - t0), ok)


def _make_handler(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 300

        def log_message(self, fmt, *args):  # route through stats, not stderr
            pass

        def _reply(self, status: int, payload: dict):
            self._reply_bytes(status, json.dumps(payload).encode(), "application/json")

        def _reply_bytes(self, status: int, data: bytes, ctype: str):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            if server.draining:
                # shutting down: finish this response, then close, so a
                # kept-alive client cannot prolong the drain
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            with server.track_request():
                self._do_get()

        def do_POST(self):
            with server.track_request():
                self._do_post()

        def _do_get(self):
            if self.path == "/metrics":  # a scrape is not recorded in stats
                self._reply_bytes(200, server.metrics_text().encode(),
                                  "text/plain; version=0.0.4")
                return
            if self.path == "/viewer":  # the static page fetch is not recorded
                try:
                    self._reply_bytes(200, server.viewer_html(), "text/html; charset=utf-8")
                except ServerError as e:
                    self._reply(404, {"error": str(e)})
                return
            status, payload = server.handle("GET", self.path, None)
            self._reply(status, payload)

        def _do_post(self):
            is_npz_req = NPZ_CONTENT_TYPE in (self.headers.get("Content-Type") or "")
            wants_npz = is_npz_req or NPZ_CONTENT_TYPE in (self.headers.get("Accept") or "")
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length < 0 or length > 512 << 20:
                    self.close_connection = True
                    self._reply(413, {"error": "request body too large"})
                    return
                raw = self.rfile.read(length)
                if is_npz_req:
                    body = _npz_to_body(raw) if raw else {}
                else:
                    body = json.loads(raw) if raw else {}
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                kind = "npz" if is_npz_req else "JSON"
                self._reply(400, {"error": f"bad {kind} body: {e}"})
                return
            status, payload = server.handle("POST", self.path, body, raw=wants_npz)
            if wants_npz and status == 200:
                self._reply_bytes(status, _body_to_npz(payload), NPZ_CONTENT_TYPE)
            else:
                self._reply(status, payload)

    return Handler


def serve(
    engine: InferenceEngine, host: str = "127.0.0.1", port: int = 8080,
    gmm=None, micro_batch: bool = True, viewer_mesh: tuple | None = None,
) -> tuple[ThreadingHTTPServer, ModelServer]:
    """Bind and return (httpd, model_server); the caller runs
    httpd.serve_forever() (or spawns a thread for it)."""
    ms = ModelServer(engine, gmm=gmm, micro_batch=micro_batch, viewer_mesh=viewer_mesh)
    return ThreadingHTTPServer((host, port), _make_handler(ms)), ms


def main(argv=None):
    import argparse
    import signal
    import sys

    import torch

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fresh-init", action="store_true")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--no-micro-batch", action="store_true")
    ap.add_argument("--workdir", default="results")
    ap.add_argument("--artifact", default=None,
                    help="serve a .capex export instead of a checkpoint")
    own, rest = ap.parse_known_args(argv)

    from cape_tpu_torch.apps.main import require_device

    if own.artifact:
        # checkpoint-mode flags (batch size, config, --fresh-init,
        # --workdir, ...) cannot apply to a baked artifact; ignoring them
        # would let an operator believe they configured something
        if own.fresh_init:
            rest = ["--fresh-init"] + rest
        if own.workdir != "results":
            rest = ["--workdir", own.workdir] + rest
        if rest:
            print(f"error: unsupported flags with --artifact: {rest}", file=sys.stderr)
            sys.exit(2)
        require_device(own.device)
        from cape_tpu_torch.tools.export_model import ExportedEngine, ExportedModel

        engine = ExportedEngine(ExportedModel.load(own.artifact, device=own.device))
    else:
        from cape_tpu_torch.apps.main import build_context, resolve_config, restore_params
        from cape_tpu_torch.core import prng
        from cape_tpu_torch.core.config import parse_cli
        from cape_tpu_torch.models.cape import CAPE

        cfg = resolve_config(parse_cli(rest))
        if not cfg.name:
            print("error: --name is required", file=sys.stderr)
            sys.exit(2)
        require_device(own.device)
        # --data_parallel N > 1: one server process drives N devices (batch
        # axis split, batch_size rows per device) for bulk throughput; the
        # default stays one device
        dp = None
        if cfg.data_parallel > 1:
            from cape_tpu_torch.parallel.mesh import DataParallel, local_devices

            dp = DataParallel(cfg.data_parallel, local_devices(torch.device(own.device).type))
            print(f"serving over a {dp.num_devices}-device mesh", flush=True)
        model = CAPE(cfg)
        ctx = build_context(cfg)
        if own.fresh_init:
            model.init_params(prng.PRNGKey(cfg.seed), ctx)  # as JAX's server
        else:
            restore_params(cfg, model, ctx, own.workdir)
        engine = InferenceEngine(model, ctx, cfg.batch_size, device=own.device, dp=dp)
    name = engine.model.cfg.name

    gmm = None
    if engine.model.cfg.nz == 18:  # the shipped prior's dimensionality
        try:
            from cape_tpu_torch.models.gmm import GMM

            gmm = GMM.load_pretrained()
        except Exception as e:
            print(f"GMM prior unavailable ({e}); /sample prior='gmm' disabled", flush=True)
    httpd, ms = serve(engine, own.host, own.port, gmm=gmm,
                      micro_batch=not own.no_micro_batch)

    # SIGTERM and SIGINT stop the accept loop from a side thread
    # (httpd.shutdown() from the handler's own thread would deadlock
    # serve_forever); the drain below then waits for the requests in
    # flight. Registered before the port is announced.
    def _stop(signum, frame):
        print(f"received signal {signum}: draining", flush=True)
        ms.draining = True  # before shutdown: responses now close connections
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    if not own.no_warmup:
        print(f"warmup done in {ms.warmup():.1f}s", flush=True)
    print(f"serving {name} on http://{own.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        ms.draining = True
        if not ms.drain(timeout=30.0):
            print("drain timed out with requests in flight", flush=True)
        httpd.server_close()
        print("server closed", flush=True)


if __name__ == "__main__":
    main()
