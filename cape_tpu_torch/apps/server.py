"""HTTP model server: the JSON / npz wire API of `cape_tpu.apps.server`
over the PyTorch `InferenceEngine`.

  python -m cape_tpu_torch.apps.server --config configs/<preset>.yaml \
      --name run1 [--fresh-init] [--batch_size 32] [--device cpu] [--port 0]

It runs on the GPU; without one it raises unless `--device cpu` asks for
the CPU.

Endpoints (arrays are nested JSON lists, float32 on the wire; POST an
`np.savez` archive with `Content-Type: application/x-npz` and/or send
`Accept: application/x-npz` for binary arrays; errors are always JSON):
  GET  /health       -> model identity, dims, batch size
  GET  /stats        -> per-endpoint request counts + latency quantiles
  POST /encode       {disp [N,V,3], pose [N,cond_dim], clo [N,cond2_dim]}
                     -> {z_mean, z_logvar, y, y2}
  POST /decode       {z [N,nz], pose, clo} or {z_total, y, y2} -> {disp}
  POST /reconstruct  {disp, pose, clo, sample?: bool, seed?: int} -> {disp}
  POST /sample       {pose [1|N,..], clo [1|N,..], n?: int, seed?: int}
                     -> {disp, z}

The HTTP layer is threaded; device work goes through one lock, one
request at a time (the JAX server's --no-micro-batch mode). Not ported
yet, and answered with 501 or refused at start: dynamic micro-batching,
GET /metrics, GET /viewer, the GMM prior (prior="gmm"), --artifact and
--data_parallel.
"""

from __future__ import annotations

import io
import json
import threading
import time
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


class ModelServer:
    """Request handling around one InferenceEngine; transport lives in
    `serve()` so tests can call handle() directly too."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self.stats = _Stats()
        self._device_lock = threading.Lock()
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
            "gmm_prior": False,
            "device": str(engine.device),
        }

    def warmup(self) -> float:
        """Run every stage once (and build the CUDA kernel on a GPU) so the
        first request pays no set-up. Returns elapsed seconds."""
        t0 = time.perf_counter()
        cfg = self.engine.model.cfg
        disp = np.zeros((1, self.info["num_verts"], 3), np.float32)
        pose = np.zeros((1, cfg.cond_dim), np.float32)
        clo = np.zeros((1, cfg.cond2_dim), np.float32)
        with self._device_lock:
            self.engine.autoencode(disp, pose, clo, sample=True)
        return time.perf_counter() - t0

    def _embed_then_decode(self, z: np.ndarray, pose: np.ndarray, clo: np.ndarray):
        """The generation path of /sample and /decode-with-z: pose/clo may
        have 1 row for n z-rows; the condition net runs on the unique rows
        and the embedding broadcasts host-side."""
        with self._device_lock:
            y, y2 = self.engine.encode_only_condition(pose, clo)
            y, y2 = broadcast_conditions(y, y2, len(z))
            return self.engine.decode(np.concatenate([z, y, y2], axis=-1), y, y2)

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
        with self._device_lock:
            z_mean, z_logvar, y, y2 = self.engine.encode(disp, pose, clo)
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
            with self._device_lock:
                return {"disp": self.engine.decode(zt, y, y2)}
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
        with self._device_lock:
            out = self.engine.autoencode(disp, pose, clo, rng=seed, sample=sample)
        return {"disp": out}

    def handle_sample(self, body: dict) -> dict:
        cfg = self.engine.model.cfg
        n = _as_int(body, "n", 1)
        if not 1 <= n <= 1024:
            raise ServerError("n must be in [1, 1024]")
        pose, clo = self._conditions(body, n=n)
        prior = body.get("prior", "normal")
        seed = _as_int(body, "seed", 0, min_value=0)
        if prior == "gmm":
            raise NotImplementedError(
                "prior='gmm': the GMM latent prior is not ported to cape_tpu_torch yet"
            )
        if prior != "normal":
            raise ServerError(f"unknown prior {prior!r} (use 'normal' or 'gmm')")
        # the same host draw as the JAX server, so one seed gives one z there and here
        z = np.random.default_rng(seed).standard_normal((n, cfg.nz)).astype(np.float32)
        return {"disp": self._embed_then_decode(z, pose, clo), "z": z}

    # ------------------------------------------------------------ routing
    _POST = {
        "/encode": handle_encode,
        "/decode": handle_decode,
        "/reconstruct": handle_reconstruct,
        "/sample": handle_sample,
    }
    _NOT_PORTED = {
        "/metrics": "GET /metrics (Prometheus exposition)",
        "/viewer": "GET /viewer (the WebGL viewer page)",
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
                return 200, self.stats.snapshot()
            if method == "GET" and path in self._NOT_PORTED:
                raise NotImplementedError(
                    f"{self._NOT_PORTED[path]} is not ported to cape_tpu_torch yet"
                )
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
        except NotImplementedError as e:
            ok = False
            return 501, {"error": str(e)}
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
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            status, payload = server.handle("GET", self.path, None)
            self._reply(status, payload)

        def do_POST(self):
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
    micro_batch: bool = False,
) -> tuple[ThreadingHTTPServer, ModelServer]:
    """Bind and return (httpd, model_server); the caller runs
    httpd.serve_forever() (or spawns a thread for it)."""
    if micro_batch:
        raise NotImplementedError(
            "dynamic micro-batching is not ported to cape_tpu_torch yet "
            "(the server runs one request at a time behind a device lock)"
        )
    ms = ModelServer(engine)
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
    ap.add_argument("--workdir", default="results")
    ap.add_argument("--artifact", default=None)
    own, rest = ap.parse_known_args(argv)
    if own.artifact:
        raise NotImplementedError(
            "--artifact (serving an AOT export) is not ported to cape_tpu_torch yet"
        )

    from cape_tpu_torch.apps.main import (
        build_context, require_device, resolve_config, restore_params,
    )
    from cape_tpu_torch.core.config import parse_cli
    from cape_tpu_torch.models.cape import CAPE

    cfg = resolve_config(parse_cli(rest))
    if not cfg.name:
        print("error: --name is required", file=sys.stderr)
        sys.exit(2)
    if cfg.data_parallel > 1:
        raise NotImplementedError(
            "--data_parallel is not ported to cape_tpu_torch yet (one device per server)"
        )
    require_device(own.device)
    model = CAPE(cfg)
    ctx = build_context(cfg)
    if own.fresh_init:
        model.init_params(torch.Generator().manual_seed(cfg.seed), ctx)
    else:
        restore_params(cfg, model, ctx, own.workdir)
    engine = InferenceEngine(model, ctx, cfg.batch_size, device=own.device)
    httpd, ms = serve(engine, own.host, own.port)

    def _stop(signum, frame):
        print(f"received signal {signum}: stopping", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    print(f"warmup done in {ms.warmup():.1f}s", flush=True)
    print(f"serving {cfg.name} on http://{own.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        print("server closed", flush=True)


if __name__ == "__main__":
    main()
