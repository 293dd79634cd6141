"""The generator of `serve` mixes: open-loop `POST /sample` traffic.

A mix file of this kind holds `rate` (requests a second), `sizes` ({meshes
a request: share of requests}), `pose_std`, `warmup_requests` (sent
before the window, at the rate), `profile_seconds` (the traced run's
profiled stretch), `tail_seconds` (how long after the window's close the
client waits for answers still due), `check` ({meshes a request: how many
such requests the check compares}), `batch_size` (the server's padded
call) and `compute_dtype`.

Every seed gets the same work in another order: `rate x seconds` requests
whose sizes are the mix's shares exactly, and whose gaps are the
quantiles of an exponential of mean 1/rate (a Poisson process's gaps),
both shuffled by the seed. Each request carries a pose of 14 clothing
joints (axis-angle N(0, pose_std^2) per component, as 3x3 rotations: 126
numbers), a clothing type (one hot of 4), `n` and a `seed` of its own,
all drawn from the run's seed.
"""

from __future__ import annotations

import io

import numpy as np

JOINTS = 14


def rodrigues(aa: np.ndarray) -> np.ndarray:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]."""
    theta = np.maximum(np.linalg.norm(aa, axis=-1, keepdims=True), 1e-8)
    k = aa / theta
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = np.zeros_like(kx)
    K = np.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], -1).reshape(*aa.shape[:-1], 3, 3)
    s, c = np.sin(theta)[..., None], np.cos(theta)[..., None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def requests(mix: dict, seed: int, seconds: float, stream: int = 0) -> list[dict]:
    """The requests of a stretch of `seconds` at the mix's rate: each
    {"due" (seconds from the stretch's start), "n", "pose" [1, 126],
    "clo" [1, 4], "seed"}. `stream` tells apart the stretches of one run
    (warm-up, window, profiled stretch)."""
    rng = np.random.default_rng((int(seed), stream))
    count = max(1, int(round(mix["rate"] * seconds)))
    sizes = []
    for n, share in sorted(mix["sizes"].items(), key=lambda kv: int(kv[0])):
        sizes += [int(n)] * int(round(share * count))
    sizes = (sizes + [int(min(mix["sizes"], key=int))] * count)[:count]
    sizes = rng.permutation(np.asarray(sizes))
    gaps = -np.log1p(-(np.arange(count) + 0.5) / count) / mix["rate"]
    due = np.cumsum(rng.permutation(gaps)) - gaps.min()
    aa = mix["pose_std"] * rng.standard_normal((count, JOINTS, 3))
    pose = rodrigues(aa).reshape(count, 1, JOINTS * 9).astype(np.float32)
    clo = np.eye(4, dtype=np.float32)[rng.integers(0, 4, count)][:, None, :]
    seeds = rng.integers(0, 2 ** 31, count)
    return [{"due": float(due[i]), "n": int(sizes[i]), "pose": pose[i], "clo": clo[i],
             "seed": int(seeds[i])} for i in range(count)]


def body(req: dict) -> bytes:
    """The request's npz body (the client's default wire)."""
    buf = io.BytesIO()
    np.savez(buf, pose=req["pose"], clo=req["clo"], n=np.int64(req["n"]),
             seed=np.int64(req["seed"]))
    return buf.getvalue()


def latents(req: dict, nz: int) -> np.ndarray:
    """The z a /sample request's seed gives: numpy default_rng(seed)'s
    standard normals [n, nz] in float32."""
    return np.random.default_rng(req["seed"]).standard_normal((req["n"], nz)).astype(np.float32)


def judged(mix: dict, seed: int, reqs: list[dict]) -> list[int]:
    """Indices of the requests the check compares: for each size, the
    mix's `check` count of them, drawn from the seed."""
    rng = np.random.default_rng((int(seed), 99))
    out = []
    for n, k in mix["check"].items():
        idx = [i for i, r in enumerate(reqs) if r["n"] == int(n)]
        out += [int(i) for i in rng.permutation(idx)[:k]]
    return sorted(out)
