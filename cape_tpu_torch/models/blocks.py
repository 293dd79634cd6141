"""Network building blocks of the serving path.

Counterpart of `cape_tpu.models.blocks` for the flagship family: the plain
encoder conv block (with and without folded conditions), the 1x1 graph
conv and the affine decoder block with folded conditions. Functional
(init, apply) pairs over explicit parameter dicts, as in JAX.
"""

from __future__ import annotations

import torch

from cape_tpu_torch.core.params import conv_bias, conv_weight
from cape_tpu_torch.ops.cheb import cheb_conv, cheb_conv_folded


def conv_block_init(generator: torch.Generator, K: int, fin: int, fout: int) -> dict:
    return {"w": conv_weight(generator, K, fin, fout), "b": conv_bias(fout)}


def conv_block_apply(p: dict, x, lap, down, act):
    """conv -> bias + activation -> pool."""
    x = cheb_conv(x, lap, p["w"])
    x = act(x + p["b"].to(x.dtype))
    return down(x)


def conv1x1_init(generator: torch.Generator, fin: int, fout: int) -> dict:
    """K=1 'pointwise' graph conv; no bias."""
    return {"w": conv_weight(generator, 1, fin, fout)}


def conv1x1_apply(p: dict, x, lap):
    return cheb_conv(x, lap, p["w"])


def affine_block_init(generator: torch.Generator, K: int, fin: int, fout: int) -> dict:
    """Outputs fout//2 channels, as the reference's affine block does."""
    half = fout // 2
    return {
        "conv": {"w": conv_weight(generator, K, fin, half)},
        "affine": conv1x1_init(generator, fin, half),
    }


def conv_block_folded_apply(p: dict, x, conds, lap, down, act):
    """conv block on concat([x, conds...]) with folded condition channels."""
    x = cheb_conv_folded(x, conds, lap, p["w"])
    x = act(x + p["b"].to(x.dtype))
    return down(x)


def affine_block_folded_apply(p: dict, x, conds, lap, up):
    """unpool -> [cheb -> relu] + parallel 1x1 'affine' branch, summed, on
    concat([x, conds...]) taken before the unpool: the condition seed is
    commuted through the upsampling as u = U @ 1."""
    xu = up(x)
    seed = up(torch.ones((x.shape[-2], 1), dtype=x.dtype, device=x.device))
    gc = torch.relu(cheb_conv_folded(xu, conds, lap, p["conv"]["w"], cond_seed=seed))
    af = cheb_conv_folded(xu, conds, lap, p["affine"]["w"], cond_seed=seed)
    return gc + af
