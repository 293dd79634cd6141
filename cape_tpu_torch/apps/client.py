"""Python client for the model server (apps/server.py).

A copy of `cape_tpu.apps.client` (numpy and urllib only): it speaks to
either package's server.

Stdlib-only (urllib + json) with numpy in/out, mirroring the
InferenceEngine surface so code can swap between in-process and remote
inference:

    eng = InferenceEngine(model, ctx)                # in-process
    eng = CapeClient("http://gpu-host:8080")         # remote, same calls

By default requests/responses travel as binary npz (a mesh is ~82k
floats, which JSON encodes as text and npz as raw float32 bytes). Pass
wire="json" for the debuggable format. Raises CapeServerError with the
server's message on 4xx/5xx.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request

import numpy as np

_NPZ = "application/x-npz"


class CapeServerError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class CapeClient:
    def __init__(self, base_url: str, timeout: float = 300.0, wire: str = "npz"):
        if wire not in ("npz", "json"):
            raise ValueError(f"wire must be 'npz' or 'json', got {wire!r}")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.wire = wire

    # ------------------------------------------------------------- wire
    def _get(self, path: str) -> dict:
        return self._request(urllib.request.Request(self.base_url + path))

    def _post(self, path: str, body: dict) -> dict:
        body = {k: v for k, v in body.items() if v is not None}
        if self.wire == "npz":
            buf = io.BytesIO()
            np.savez(buf, **body)
            data, ctype = buf.getvalue(), _NPZ
        else:
            data = json.dumps(
                {
                    k: (v.tolist() if isinstance(v, np.ndarray) else v)
                    for k, v in body.items()
                }
            ).encode()
            ctype = "application/json"
        return self._request(
            urllib.request.Request(
                self.base_url + path, data,
                {"Content-Type": ctype, "Accept": ctype},
            )
        )

    def _request(self, req) -> dict:
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
                if _NPZ in (resp.headers.get("Content-Type") or ""):
                    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                        return {
                            k: (v.item() if v.ndim == 0 else v)
                            for k, v in z.items()
                        }
                return json.loads(raw)
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", "")
            except Exception:
                msg = e.reason
            raise CapeServerError(e.code, msg) from None

    # ---------------------------------------------------------- surface
    def health(self) -> dict:
        return self._get("/health")

    def stats(self) -> dict:
        return self._get("/stats")

    def encode(self, disp, pose, clo):
        """disp [N,V,3] -> (z_mean, z_logvar, y, y2)."""
        r = self._post(
            "/encode",
            {"disp": np.asarray(disp), "pose": np.asarray(pose), "clo": np.asarray(clo)},
        )
        return tuple(
            np.asarray(r[k], np.float32) for k in ("z_mean", "z_logvar", "y", "y2")
        )

    def decode(self, z=None, pose=None, clo=None, z_total=None, y=None, y2=None):
        """Either (z, pose, clo) or the pre-embedded (z_total, y, y2)."""
        arr = lambda v: None if v is None else np.asarray(v)
        if z_total is not None:
            # keep None as None (dropped by _post) so a missing y/y2 is the
            # server's clean 400, not np.asarray(None) pickled into the npz
            body = {"z_total": arr(z_total), "y": arr(y), "y2": arr(y2)}
        else:
            body = {"z": arr(z), "pose": arr(pose), "clo": arr(clo)}
        return np.asarray(self._post("/decode", body)["disp"], np.float32)

    def reconstruct(self, disp, pose, clo, sample: bool = False, seed: int = 0):
        r = self._post(
            "/reconstruct",
            {
                "disp": np.asarray(disp), "pose": np.asarray(pose),
                "clo": np.asarray(clo), "sample": sample, "seed": seed,
            },
        )
        return np.asarray(r["disp"], np.float32)

    def sample(self, pose, clo, n: int = 1, prior: str = "normal", seed: int = 0):
        """Returns (disp [n,V,3], z [n,nz]); 1-row pose/clo broadcast over n."""
        r = self._post(
            "/sample",
            {
                "pose": np.asarray(pose), "clo": np.asarray(clo),
                "n": n, "prior": prior, "seed": seed,
            },
        )
        return np.asarray(r["disp"], np.float32), np.asarray(r["z"], np.float32)
