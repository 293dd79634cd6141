"""The generator of `train` mixes: a synthetic, CAPE-shaped training set
made on the device from the run's seed.

A mix file of this kind holds `batch_size`, `n_train` (frames in the train
split), `steps_per_dispatch` (steps a dispatch chunk takes, as the
Trainer's `steps_per_dispatch`), `profile_steps` (the traced run's
profiled steps), `rank` and `noise` of the displacement model, `pose_std`
and `chunk` (frames made per call).

Each frame: a pose of 14 clothing joints, each a rotation by an
axis-angle of N(0, pose_std^2) per component, given as its 3x3 matrix
(126 numbers, the configurations' `pose_type: rot`); a clothing type, one
hot of 4; and a per-vertex displacement [V, 3], a low-rank smooth
function of pose and clothing type (`rank` fields of N(0, 1) over the
vertices, mixed by a tanh of random projections) plus N(0, noise^2): the
z-scored displacements the Trainer holds, as `data/synthetic.py` of the
program models them. Frames come in chunks from one `torch.Generator` of
the device, so a seed gives the same frames on every call; `sink`
receives each chunk in the natural vertex order.
"""

from __future__ import annotations

import torch

JOINTS = 14


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]."""
    theta = aa.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    k = aa / theta
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], -1).reshape(*aa.shape[:-1], 3, 3)
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * K + (1 - c) * (K @ K)


def generate(mix: dict, seed: int, num_verts: int, device, sink) -> None:
    """Make the mix's `n_train` frames; calls sink(begin, disp [n, V, 3],
    pose [n, 126], clo [n, 4]) for each chunk, in order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    r = mix["rank"]
    basis = torch.randn((r, num_verts * 3), generator=gen, device=device) / r ** 0.5
    pose_proj = torch.randn((JOINTS * 3, r), generator=gen, device=device) / (JOINTS * 3) ** 0.5
    clo_proj = torch.randn((4, r), generator=gen, device=device)
    n, chunk = mix["n_train"], mix["chunk"]
    for begin in range(0, n, chunk):
        k = min(chunk, n - begin)
        aa = mix["pose_std"] * torch.randn((k, JOINTS * 3), generator=gen, device=device)
        clo = torch.nn.functional.one_hot(
            torch.randint(0, 4, (k,), generator=gen, device=device), 4).float()
        coeff = torch.tanh(aa @ pose_proj + clo @ clo_proj) * 2.0
        disp = coeff @ basis + mix["noise"] * torch.randn((k, num_verts * 3), generator=gen,
                                                          device=device)
        pose = rodrigues(aa.reshape(k, JOINTS, 3)).reshape(k, JOINTS * 9)
        sink(begin, disp.reshape(k, num_verts, 3), pose, clo)


def resident(mix: dict, seed: int, num_verts: int, device, perm0=None) -> dict:
    """The whole train split on the device, {disp, pose, clo}, with disp's
    vertices in the order `perm0` (row r holds natural vertex perm0[r];
    None: natural)."""
    n = mix["n_train"]
    out = {"disp": torch.empty((n, num_verts, 3), device=device),
           "pose": torch.empty((n, JOINTS * 9), device=device),
           "clo": torch.empty((n, 4), device=device)}
    idx = None if perm0 is None else torch.as_tensor(perm0, device=device)

    def sink(begin, disp, pose, clo):
        rows = slice(begin, begin + len(disp))
        out["disp"][rows] = disp if idx is None else disp.index_select(1, idx)
        out["pose"][rows] = pose
        out["clo"][rows] = clo

    generate(mix, seed, num_verts, device, sink)
    return out


def rows(mix: dict, seed: int, num_verts: int, device, index) -> dict:
    """Frames `index` (a 1-d array of row numbers) in the natural vertex
    order, without holding the whole split."""
    index = torch.as_tensor(index, device=device, dtype=torch.long)
    out = {"disp": torch.empty((len(index), num_verts, 3), device=device),
           "pose": torch.empty((len(index), JOINTS * 9), device=device),
           "clo": torch.empty((len(index), 4), device=device)}

    def sink(begin, disp, pose, clo):
        hit = (index >= begin) & (index < begin + len(disp))
        where = hit.nonzero().ravel()
        local = index[where] - begin
        out["disp"][where] = disp[local]
        out["pose"][where] = pose[local]
        out["clo"][where] = clo[local]

    generate(mix, seed, num_verts, device, sink)
    return out
