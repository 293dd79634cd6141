"""Network building blocks: conv/pool stacks and residual variants.

Counterpart of `cape_tpu.models.blocks`, form for form. Functional (init,
apply) pairs over explicit parameter dicts, as in JAX:

  conv_block   - conv -> bias + act -> pool          (the reference's cnp)
  deconv_block - unpool -> conv -> bias + act        (udn)
  res_block    - encoder residual block
  cmr_block    - GraphCMR group-norm decoder residual block
  affine_block - affine decoder residual block

The folded forms take the conditions symbolically (ops.cheb
cheb_conv_folded) instead of a per-vertex broadcast concat; the fused forms
also compose the unpool into the conv (ops.cheb cheb_conv_up). Both are
exact and parameter-compatible with the concat forms.

Under tensor parallelism (`parallel.mesh2d`) the convs take their weight
shards (ops.cheb); a sharded bias or group-norm gamma/beta is gathered
where it is added (`mesh2d.full`).
"""

from __future__ import annotations

import torch

from cape_tpu_torch.core.params import conv_bias, conv_weight, split
from cape_tpu_torch.ops.cheb import _project, cheb_conv, cheb_conv_folded, cheb_conv_up_folded
from cape_tpu_torch.ops.norm import group_norm_relu
from cape_tpu_torch.parallel.mesh2d import full, shard_apply


def _bias(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return full(b).to(x.dtype)


# ---------------------------------------------------------------- plain conv
def conv_block_init(key, K: int, fin: int, fout: int) -> dict:
    return {"w": conv_weight(key, K, fin, fout), "b": conv_bias(fout)}


def conv_block_apply(p: dict, x, lap, down, act):
    """conv -> bias + activation -> pool."""
    x = cheb_conv(x, lap, p["w"])
    x = act(x + _bias(p["b"], x))
    return down(x)


def deconv_block_apply(p: dict, x, lap, up, act):
    """unpool -> conv -> bias + activation."""
    x = cheb_conv(up(x), lap, p["w"])
    return act(x + _bias(p["b"], x))


def conv1x1_init(key, fin: int, fout: int) -> dict:
    """K=1 'pointwise' graph conv; no bias."""
    return {"w": conv_weight(key, 1, fin, fout)}


def conv1x1_apply(p: dict, x, lap):
    return cheb_conv(x, lap, p["w"])


# ------------------------------------------------------------- encoder resid
def res_block_init(key, K: int, fin: int, fout: int) -> dict:
    keys = split(key, 3)
    p = {
        "conv1": {"w": conv_weight(keys[0], K, fin, fout), "b": conv_bias(fout)},
        "conv2": {"w": conv_weight(keys[1], K, fout, fout), "b": conv_bias(fout)},
    }
    if fin != fout:
        p["proj"] = conv1x1_init(keys[2], fin, fout)
    return p


def res_block_apply(p: dict, x_in, lap, down, act):
    """conv -> act -> conv, plus the (projected) skip -> act -> pool."""
    x = cheb_conv(x_in, lap, p["conv1"]["w"])
    x = act(x + _bias(p["conv1"]["b"], x))
    x = cheb_conv(x, lap, p["conv2"]["w"])
    skip = conv1x1_apply(p["proj"], x_in, lap) if "proj" in p else x_in
    x = act(x + skip + _bias(p["conv2"]["b"], x))
    return down(x)


# ---------------------------------------------------------- CMR decoder resid
def cmr_block_init(key, K: int, fin: int, fout: int) -> dict:
    keys = split(key, 4)
    half = fout // 2
    norm = lambda c: {"gamma": torch.ones((c,)), "beta": torch.zeros((c,))}
    p = {
        "gn0": norm(fin),
        "lin1": conv1x1_init(keys[0], fin, half),
        "gn1": norm(half),
        "conv": {"w": conv_weight(keys[1], K, half, half)},
        "gn2": norm(half),
        "lin2": conv1x1_init(keys[2], half, fout),
    }
    if fin != fout:
        p["proj"] = conv1x1_init(keys[3], fin, fout)
    return p


def _norm(p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    return full(p["gamma"]), full(p["beta"])


def cmr_block_apply(p: dict, x_in, lap, up, n_valid: int | None = None):
    """unpool -> [GN -> relu -> 1x1 -> GN -> relu -> cheb -> GN -> relu -> 1x1]
    plus the (projected) skip (GraphCMR, 1905.03244). n_valid: the natural
    vertex count of the unpooled level in the padded layout, where the
    group-norm statistics run over valid rows only (ops.norm). Each GN ->
    relu is one `group_norm_relu`: on CUDA a hand-written kernel."""
    xu = up(x_in)
    x = group_norm_relu(xu, *_norm(p["gn0"]), n_valid=n_valid)
    x = conv1x1_apply(p["lin1"], x, lap)
    x = group_norm_relu(x, *_norm(p["gn1"]), n_valid=n_valid)
    x = cheb_conv(x, lap, p["conv"]["w"])
    x = group_norm_relu(x, *_norm(p["gn2"]), n_valid=n_valid)
    x = conv1x1_apply(p["lin2"], x, lap)
    skip = conv1x1_apply(p["proj"], xu, lap) if "proj" in p else xu
    return x + skip


# -------------------------------------------------------- affine decoder resid
def affine_block_init(key, K: int, fin: int, fout: int) -> dict:
    """Outputs fout//2 channels, as the reference's affine block does."""
    keys = split(key, 2)
    half = fout // 2
    return {
        "conv": {"w": conv_weight(keys[0], K, fin, half)},
        "affine": conv1x1_init(keys[1], fin, half),
    }


def affine_block_apply(p: dict, x_in, lap, up):
    """unpool -> [cheb -> relu] + a parallel 1x1 'affine' branch, summed."""
    x = up(x_in)
    return torch.relu(cheb_conv(x, lap, p["conv"]["w"])) + conv1x1_apply(p["affine"], x, lap)


# ---------------------------------------------------- condition-folded forms
def _up_seed(x: torch.Tensor, up) -> torch.Tensor:
    """u = U @ 1: the per-vertex coefficient of a condition concatenated
    before the unpool."""
    return up(torch.ones((x.shape[-2], 1), dtype=x.dtype, device=x.device))


def conv_block_folded_apply(p: dict, x, conds, lap, down, act):
    """conv block on concat([x, conds...]) with folded condition channels."""
    x = cheb_conv_folded(x, conds, lap, p["w"])
    x = act(x + _bias(p["b"], x))
    return down(x)


def deconv_block_folded_apply(p: dict, x, conds, lap, up, act):
    """deconv block whose input was concat([x, conds...]) before the
    unpool; the condition seed is commuted through it as u = U @ 1."""
    x = cheb_conv_folded(up(x), conds, lap, p["w"], cond_seed=_up_seed(x, up))
    return act(x + _bias(p["b"], x))


def affine_block_folded_apply(p: dict, x, conds, lap, up):
    """The affine block with folded conditions (see deconv_block_folded_apply)."""
    xu, seed = up(x), _up_seed(x, up)
    gc = torch.relu(cheb_conv_folded(xu, conds, lap, p["conv"]["w"], cond_seed=seed))
    af = cheb_conv_folded(xu, conds, lap, p["affine"]["w"], cond_seed=seed)
    return gc + af


def deconv_block_fused_apply(p: dict, x, conds, up, lap_up, act):
    """The deconv block with folded conditions and the unpool composed into
    the conv (ops.cheb cheb_conv_up_folded): the projections run at the
    coarse vertex count and the unpooled input never exists."""
    x = cheb_conv_up_folded(x, conds, up, lap_up, p["w"])
    return act(x + _bias(p["b"], x))


def affine_block_fused_apply(p: dict, x, conds, up, lap_up):
    """The affine block with folded conditions and the unpool composed into
    both branches: one coarse-level product projects [conv W0 | affine Wa],
    one U apply carries both branches' k=0 terms, and L~U carries the
    conv's k=1 term. Under tensor parallelism both weights have the same
    shard (their shapes differ in K only): both branches, stacked, are
    gathered or reduced before the relu (`parallel.mesh2d.shard_apply`)."""
    wa = p["affine"]["w"]
    terms = lambda x, conds, wc: _affine_fused_terms(x, conds, up, lap_up, wc, wa)
    gc_pre, af = shard_apply(terms, x, conds, p["conv"]["w"]).unbind(0)
    return torch.relu(gc_pre) + af


def _affine_fused_terms(x, conds, up, lap_up, wc, wa):
    """[the conv branch before its relu, the affine branch], stacked, of
    affine_block_fused_apply on (a share of) the input channels."""
    wc = wc.to(x.dtype)         # [2, fin_total, half]
    wa = wa.to(x.dtype)         # [1, fin_total, half]
    fx = x.shape[-1]
    half = wc.shape[-1]
    ones = torch.ones((x.shape[-2], 1), dtype=x.dtype, device=x.device)
    s0, s1 = up(ones), lap_up(ones)         # [Vf, 1]
    if fx:
        u = up(_project(x, torch.cat([wc[0, :fx], wa[0, :fx]], dim=-1)))   # [.., Vf, 2*half]
        gc_pre = u[..., :half] + lap_up(_project(x, wc[1, :fx]))
        af = u[..., half:]
    else:   # a row shard may hold no channel of x, only conditions
        gc_pre = af = x.new_zeros(x.shape[:-2] + (s0.shape[-2], half))
    shape = (1,) * (gc_pre.dim() - 2) + (gc_pre.shape[-2], 1)
    s0, s1 = s0.reshape(shape), s1.reshape(shape)
    off = fx
    for c in conds:
        dim = c.shape[-1]
        if not dim:
            continue
        c = c.to(x.dtype)
        gc_pre = gc_pre + s0 * (c @ wc[0, off : off + dim])[..., None, :]
        gc_pre = gc_pre + s1 * (c @ wc[1, off : off + dim])[..., None, :]
        af = af + s0 * (c @ wa[0, off : off + dim])[..., None, :]
        off += dim
    if off != wc.shape[1]:
        raise ValueError(f"condition channels {off} != weight rows {wc.shape[1]}")
    return torch.stack([gc_pre, af])


def res_block_folded_apply(p: dict, x_in, conds, lap, down, act):
    """The encoder res block whose input is concat([x, conds...])."""
    x = cheb_conv_folded(x_in, conds, lap, p["conv1"]["w"])
    x = act(x + _bias(p["conv1"]["b"], x))
    x = cheb_conv(x, lap, p["conv2"]["w"])
    if "proj" in p:
        skip = cheb_conv_folded(x_in, conds, lap, p["proj"]["w"])
    else:
        skip = concat_conditions(x_in, *conds)
    x = act(x + skip + _bias(p["conv2"]["b"], x))
    return down(x)


def concat_conditions(x: torch.Tensor, *conds: torch.Tensor) -> torch.Tensor:
    """Broadcast condition vectors [B, C] across the vertices and concat
    them on the channel axis."""
    B, V, _ = x.shape
    parts = [x] + [c[:, None, :].expand(B, V, c.shape[-1]).to(x.dtype) for c in conds]
    return torch.cat(parts, dim=-1)
