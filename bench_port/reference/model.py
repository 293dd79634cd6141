"""CAPE in plain PyTorch: the benchmark's reference of the model and its
GAN train step.

Written from CAPE's published description (Ma et al., "Learning to Dress
3D People in Generative Clothing", CVPR 2020; qianlim/CAPE `lib/models.py`,
`lib/losses.py`): a conditional mesh VAE of Chebyshev graph convolutions
over the SMPL template's pyramid, its two condition nets (pose: two dense
layers, clothing type: one), and a patchwise graph discriminator on the
ds2 pyramid, trained as a GAN with the reference's losses and a
per-player SGD with momentum, clipped by each player's global norm.
Everything runs in the natural vertex order without padding, the
conditions are concatenated to the vertex features where the published
model concatenates them, and every operator is the raw published matrix
(`reference.mesh`). It imports neither JAX nor anything of the program.

The model families covered: the affine decoder (`affine: 1`) and the
GraphCMR group-norm decoder (`affine: 0`), both with `use_res_block_dec:
1` and one clothing condition layer, under any of CAPE's four encoders:
plain blocks (conv -> act -> pool) or residual ones (`use_res_block: 1`:
conv -> act -> conv plus the skip, projected by a 1x1 conv where the
widths differ, -> act -> pool), each with or without the conditions
concatenated at every vertex of its input (`cond_encoder: 1`).

Parameters are a flat dict {dotted name: tensor} in float32; `dtype` is
the compute dtype every parameter is cast to where it is used.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LEAKY = 0.2
CLIP_NORM = 5.0
WARMUP_EPOCHS = 8


def channels(s: dict) -> list[int]:
    """Output channels of the encoder's layers (CAPE's plan per depth)."""
    nf = s["nf"]
    plans = {4: [nf, 2 * nf, 2 * nf, nf], 6: [nf, nf, 2 * nf, 2 * nf, 4 * nf, 4 * nf],
             8: [nf, nf, 2 * nf, 2 * nf, 4 * nf, 4 * nf, 8 * nf, 8 * nf]}
    return plans[s["num_conv_layers"]]


_COVERED = {"n_layer_cond": 1, "use_res_block_dec": 1, "activation": "b1leakyrelu",
            "optimizer": "sgd", "loss": "l1", "loss_mask": "", "K": 2}


def _check(s: dict) -> None:
    unsupported = {k: s[k] for k, want in _COVERED.items() if s[k] != want}
    if unsupported:
        raise NotImplementedError(f"the reference does not cover {unsupported}")


def _cond_hidden(y_dim: int, nz_cond: int) -> int:
    if nz_cond < y_dim // 2:
        return y_dim // 2
    if nz_cond < y_dim * 2:
        return y_dim
    return nz_cond // 2


def param_spec(s: dict, level_sizes: list[int], level_sizes_d: list[int]) -> dict:
    """{name: (shape, init)}: init is "trunc" (N(0, 0.1) cut at 2 sigma),
    "glorot" (uniform), or a constant."""
    _check(s)
    F_ = channels(s)
    K, Kd = s["K"], s["Kd"]
    ncond = s["nz_cond"] + s["nz_cond2"]
    spec = {}

    def dense(name, fin, fout):
        spec[f"{name}.kernel"] = ((fin, fout), "glorot")
        spec[f"{name}.bias"] = ((fout,), 0.0)

    def conv(name, k, fin, fout, bias=True):
        spec[f"{name}.w"] = ((k, fin, fout), "trunc")
        if bias:
            spec[f"{name}.b"] = ((fout,), 0.1)

    hidden = _cond_hidden(s["cond_dim"], s["nz_cond"])
    dense("cond_pose.fc1", s["cond_dim"], hidden)
    dense("cond_pose.fc2", hidden, s["nz_cond"])
    dense("cond_clo.fc1", s["cond2_dim"], s["nz_cond2"])
    enc = "generator.encoder"
    fin = s["nn_input_channel"] + (ncond if s["cond_encoder"] else 0)
    for i, fout in enumerate(F_):
        name = f"{enc}.layer{i}"
        if s["use_res_block"]:
            conv(f"{name}.conv1", K, fin, fout)
            conv(f"{name}.conv2", K, fout, fout)
            if fin != fout:
                conv(f"{name}.proj", 1, fin, fout, bias=False)
        else:
            conv(name, K, fin, fout)
        fin = fout
    rate = F_[-1] // s["reduce_dim"]
    red = F_[-1] // rate
    conv(f"{enc}.reduce", 1, F_[-1], red, bias=False)
    dense(f"{enc}.fc_mean", level_sizes[-1] * red, s["nz"])
    dense(f"{enc}.fc_var", level_sizes[-1] * red, s["nz"])
    dec = "generator.decoder"
    dense(f"{dec}.fc1", s["nz"] + ncond, level_sizes[-1] * red)
    conv(f"{dec}.expand", 1, red, F_[-1], bias=False)
    c = F_[-1] + ncond
    for i in range(len(F_)):
        fout = F_[-(i + 1)]
        half = fout // 2
        name = f"{dec}.layer{i}"
        if s["affine"]:
            conv(f"{name}.conv", K, c, half, bias=False)
            conv(f"{name}.affine", 1, c, half, bias=False)
            c = half + ncond
        else:
            spec[f"{name}.gn0.gamma"], spec[f"{name}.gn0.beta"] = ((c,), 1.0), ((c,), 0.0)
            conv(f"{name}.lin1", 1, c, half, bias=False)
            spec[f"{name}.gn1.gamma"], spec[f"{name}.gn1.beta"] = ((half,), 1.0), ((half,), 0.0)
            conv(f"{name}.conv", K, half, half, bias=False)
            spec[f"{name}.gn2.gamma"], spec[f"{name}.gn2.beta"] = ((half,), 1.0), ((half,), 0.0)
            conv(f"{name}.lin2", 1, half, fout, bias=False)
            if c != fout:
                conv(f"{name}.proj", 1, c, fout, bias=False)
            c = fout + ncond
    conv(f"{dec}.out", K, c, s["nn_input_channel"], bias=False)
    spec[f"{dec}.out.b"] = ((level_sizes[0], s["nn_input_channel"]), 0.1)
    c = s["nn_input_channel"] + ncond
    for i in range(len(level_sizes_d) - 1):
        conv(f"discriminator.layer{i}", Kd, c, F_[i])
        c = F_[i]
    conv("discriminator.pred", K, c, 1, bias=False)
    return spec


# ------------------------------------------------------------------ layers
def _leaky(x):
    return F.leaky_relu(x, LEAKY)


def _p(P, name, dt):
    return P[name].to(dt)


def _dense(P, name, x, dt):
    return x @ _p(P, f"{name}.kernel", dt) + _p(P, f"{name}.bias", dt)


def cheb(x, lap, w):
    """sum_k T_k(L~) x W[k], T_0 = x, T_1 = L~ x, T_k = 2 L~ T_{k-1} - T_{k-2}."""
    t_prev, t = None, x
    out = x @ w[0]
    for k in range(1, w.shape[0]):
        t_next = lap(t) if k == 1 else 2.0 * lap(t) - t_prev
        t_prev, t = t, t_next
        out = out + t @ w[k]
    return out


def group_norm(x, gamma, beta, groups: int = 32, eps: float = 1e-5):
    """GraphCMR's group norm over [B, V, C]: min(32, C) groups of
    contiguous channels, statistics over the group's channels and all
    vertices."""
    B, V, C = x.shape
    G = min(groups, C)
    xg = x.transpose(1, 2).reshape(B, G, C // G, V)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(2, 3), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(B, C, V) * gamma[None, :, None] + beta[None, :, None]).transpose(1, 2)


def _concat(x, y, y2):
    B, V, _ = x.shape
    return torch.cat([x, y[:, None, :].expand(B, V, -1), y2[:, None, :].expand(B, V, -1)], -1)


# ------------------------------------------------------------------ model
def embed(P, pose, clo, dt):
    y = _dense(P, "cond_pose.fc2", _leaky(_dense(P, "cond_pose.fc1", pose.to(dt), dt)), dt)
    y2 = _dense(P, "cond_clo.fc1", clo.to(dt), dt)
    return y, y2


def encode(s, P, mesh, x, y, y2, dt):
    enc = "generator.encoder"
    x = x.to(dt)
    if s["cond_encoder"]:
        x = _concat(x, y, y2)
    for i in range(s["num_conv_layers"]):
        name, lap = f"{enc}.layer{i}", mesh.lap[i]
        if not s["use_res_block"]:
            x = cheb(x, lap, _p(P, f"{name}.w", dt))
            x = mesh.down[i](_leaky(x + _p(P, f"{name}.b", dt)))
            continue
        h = _leaky(cheb(x, lap, _p(P, f"{name}.conv1.w", dt)) + _p(P, f"{name}.conv1.b", dt))
        h = cheb(h, lap, _p(P, f"{name}.conv2.w", dt))
        skip = x @ _p(P, f"{name}.proj.w", dt)[0] if f"{name}.proj.w" in P else x
        x = mesh.down[i](_leaky(h + skip + _p(P, f"{name}.conv2.b", dt)))
    x = x @ _p(P, f"{enc}.reduce.w", dt)[0]
    x = x.reshape(x.shape[0], -1)
    return _dense(P, f"{enc}.fc_mean", x, dt), _dense(P, f"{enc}.fc_var", x, dt)


def decode(s, P, mesh, z_total, y, y2, dt):
    dec = "generator.decoder"
    x = _leaky(_dense(P, f"{dec}.fc1", z_total.to(dt), dt))
    x = x.reshape(x.shape[0], mesh.level_sizes[-1], -1) @ _p(P, f"{dec}.expand.w", dt)[0]
    for i in range(s["num_conv_layers"]):
        name = f"{dec}.layer{i}"
        lap = mesh.lap[-(i + 2)]
        xu = mesh.up[-(i + 1)](_concat(x, y, y2))
        if s["affine"]:
            x = (torch.relu(cheb(xu, lap, _p(P, f"{name}.conv.w", dt)))
                 + xu @ _p(P, f"{name}.affine.w", dt)[0])
            continue
        gn = lambda h, g: torch.relu(group_norm(h, _p(P, f"{name}.{g}.gamma", dt),
                                                _p(P, f"{name}.{g}.beta", dt)))
        h = gn(xu, "gn0") @ _p(P, f"{name}.lin1.w", dt)[0]
        h = cheb(gn(h, "gn1"), lap, _p(P, f"{name}.conv.w", dt))
        h = gn(h, "gn2") @ _p(P, f"{name}.lin2.w", dt)[0]
        skip = xu @ _p(P, f"{name}.proj.w", dt)[0] if f"{name}.proj.w" in P else xu
        x = h + skip
    x = cheb(_concat(x, y, y2), mesh.lap[0], _p(P, f"{dec}.out.w", dt))
    return x + _p(P, f"{dec}.out.b", dt)


def discriminate(s, P, mesh, x, y, y2, dt):
    x = _concat(x.to(dt), y, y2)
    for i in range(len(mesh.down_d)):
        x = cheb(x, mesh.lap_d[i], _p(P, f"discriminator.layer{i}.w", dt))
        x = mesh.down_d[i](_leaky(x + _p(P, f"discriminator.layer{i}.b", dt)))
    return cheb(x, mesh.lap_d[-1], _p(P, "discriminator.pred.w", dt))


def sample_mesh(s, P, mesh, z, pose, clo, dt):
    """/sample's generation: the condition nets, then decode [z | y | y2]."""
    y, y2 = embed(P, pose, clo, dt)
    return decode(s, P, mesh, torch.cat([z.to(dt), y, y2], -1), y, y2, dt)


# ------------------------------------------------------------------ losses
def _sigmoid_ce(logits, label: float):
    return torch.mean(logits.clamp(min=0) - logits * label + torch.log1p(torch.exp(-logits.abs())))


def gan_losses(s, P, mesh, batch, eps, dt):
    """(loss_g, loss_d, metrics): G's loss sees D through detached
    parameters; D's loss sees G's output and conditions detached."""
    y_g, y2_g = embed(P, batch["pose_g"], batch["clo_g"], dt)
    y_d, y2_d = embed(P, batch["pose_d"], batch["clo_d"], dt)
    z_mean, z_logvar = encode(s, P, mesh, batch["disp_g"], y_g, y2_g, dt)
    z = z_mean + torch.exp(0.5 * z_logvar.clamp(-30.0, 30.0)) * eps.to(dt)
    x_hat = decode(s, P, mesh, torch.cat([z, y_g, y2_g], -1), y_g, y2_g, dt)
    P_fixed = {k: (v.detach() if k.startswith("discriminator.") else v) for k, v in P.items()}
    d_fake_g = discriminate(s, P_fixed, mesh, x_hat, y_g, y2_g, dt)
    d_real = discriminate(s, P, mesh, batch["disp_d"], y_d.detach(), y2_d.detach(), dt)
    d_fake_d = discriminate(s, P, mesh, x_hat.detach(), y_g.detach(), y2_g.detach(), dt)
    gt = batch["disp_g"].to(dt)
    recon = (x_hat - gt).abs().mean()
    kl = (-0.5 * torch.sum(1.0 + z_logvar - z_mean.square()
                           - torch.exp(z_logvar.clamp(-30.0, 30.0)), -1)).mean()
    d = x_hat - gt
    e = d.index_select(1, mesh.edges[:, 0]) - d.index_select(1, mesh.edges[:, 1])
    edge = torch.sqrt(e.square().sum(-1) + 1e-12).mean()
    smooth = 0.1
    gan_g = _sigmoid_ce(d_fake_g, 1.0 - smooth)
    gan_d = _sigmoid_ce(d_real, 1.0 - smooth) + _sigmoid_ce(d_fake_d, smooth)
    fc = ("generator.encoder.fc_mean.kernel", "generator.encoder.fc_var.kernel",
          "generator.decoder.fc1.kernel")
    reg_g = 0.5 * s["regularization"] ** 2 * sum(P[k].square().sum() for k in fc)
    loss_g = (s["lambda_gan"] * gan_g + s["lambda_recon"] * recon + s["lambda_edge"] * edge
              + s["lambda_latent"] * kl + reg_g)
    loss_d = s["lambda_gan"] * gan_d
    return loss_g, loss_d, {"loss_g": loss_g, "loss_d": loss_d}


# --------------------------------------------------------------- optimizer
def lr_at(s: dict, player: str, count: int, steps_per_epoch: int) -> float:
    """CAPE's schedule in float32: linear warm-up over 8 epochs' worth of
    decay periods, then a staircase decay; D's rate is lr * lr_scaler."""
    f32 = np.float32
    base = s["lr"] * (s["lr_scaler"] if player == "d" else 1.0)
    decay_steps = max(int(s["decay_every"] * steps_per_epoch), 1)
    warmup = int(WARMUP_EPOCHS * decay_steps) if s["lr_warmup"] else 0
    step = f32(count)
    if warmup > 0 and step < warmup:
        return float(f32(base) * step / f32(warmup))
    return float(f32(base) * f32(s["decay_rate"]) ** np.floor((step - f32(warmup)) / f32(decay_steps)))


def player(name: str) -> str:
    return "d" if name.startswith("discriminator.") else "g"


def train_steps(s, P, mesh, batches, eps, steps_per_epoch: int, dt=torch.float32):
    """len(batches) GAN steps from the float32 parameters P (updated in
    place). Returns (each step's metrics as floats, the first step's
    gradients as the optimizer takes them: clipped, by name)."""
    names = list(P)
    for v in P.values():
        v.requires_grad_(True)
    trace, first, out = {}, None, []
    decay = float(np.float32(s["momentum"]))
    for i, (batch, e) in enumerate(zip(batches, eps)):
        loss_g, loss_d, metrics = gan_losses(s, P, mesh, batch, e, dt)
        grads = torch.autograd.grad(loss_g + loss_d, [P[n] for n in names], allow_unused=True)
        grads = {n: (torch.zeros_like(P[n]) if g is None else g.float())
                 for n, g in zip(names, grads)}
        with torch.no_grad():
            clipped = {}
            for who in ("g", "d"):
                mine = [n for n in names if player(n) == who]
                norm = torch.sqrt(sum(grads[n].square().sum() for n in mine))
                for n in mine:
                    clipped[n] = torch.where(norm < CLIP_NORM, grads[n], grads[n] / norm * CLIP_NORM)
                lr = lr_at(s, who, i, steps_per_epoch)
                for n in mine:
                    trace[n] = clipped[n] if n not in trace else clipped[n] + trace[n] * decay
                    P[n].add_(-lr * trace[n])
            if first is None:
                first = clipped
        out.append({k: float(v.detach()) for k, v in metrics.items()})
    for v in P.values():
        v.requires_grad_(False)
    return out, first
