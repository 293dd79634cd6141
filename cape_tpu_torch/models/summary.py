"""Architecture printout: the per-layer table that the reference prints
when it builds its graph ('{name}: (vertices, channels), K={order}' lines
per encoder, decoder and discriminator layer, plus the condition nets).

Counterpart of `cape_tpu.models.summary`, line for line: the table comes
from (CAPEConfig, GraphContext) alone, plus the parameter counts of each
group when the model's parameter tree is given (`model.params`).
"""

from __future__ import annotations

from typing import Any



def _count(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return int(tree.numel())


def describe(model, ctx, params: dict | None = None) -> str:
    """Human-readable architecture table for a CAPE model on a pyramid.

    Mirrors the reference's graph-build printout (see module docstring);
    vertex counts come from ctx.level_sizes / level_sizes_d (natural,
    pre-padding — the padded layout is an internal device detail).
    params (the model's `params` tree) adds the parameter counts.
    """
    from cape_tpu_torch.models.cape import _cond_hidden_width

    cfg = model.cfg
    V = ctx.level_sizes
    lines: list[str] = []
    add = lines.append

    ncond = cfg.nz_cond + cfg.nz_cond2
    add(f"CAPE ({'affine' if cfg.affine else 'cmr' if cfg.use_res_block_dec else 'plain'}"
        f" decoder blocks, {'res' if cfg.use_res_block else 'plain'} encoder blocks,"
        f" compute={cfg.compute_dtype})")

    add("------------Conditions------------")
    ph = _cond_hidden_width(cfg.cond_dim, cfg.nz_cond)
    add(f"condition_pose_fc1: ({cfg.cond_dim}, {ph})")
    add(f"condition_pose_fc2: ({ph}, {cfg.nz_cond})")
    if cfg.n_layer_cond == 1:
        add(f"condition_clotype_fc1: ({cfg.cond2_dim}, {cfg.nz_cond2})")
    else:
        ch = _cond_hidden_width(cfg.cond2_dim, cfg.nz_cond2)
        add(f"condition_clotype_fc1: ({cfg.cond2_dim}, {ch})")
        add(f"condition_clotype_fc2: ({ch}, {cfg.nz_cond2})")

    add("------------Encoder------------")
    enc_chans = model._encoder_channels()
    F, K = cfg.channels, cfg.K
    for i in range(cfg.num_conv_layers):
        # printed vertex count = after this layer's pool, as the reference does
        add(f"encoder_layer{i}: ({V[i + 1]}, {F[i]}), K={K}  [in {enc_chans[i]}ch @ {V[i]}v]")
    enc_out_c = F[-1]
    if cfg.reduce_dim > 0:
        enc_out_c = F[-1] // cfg.reduce_rate
        add(f"encoder_1x1conv: ({V[-1]}, {enc_out_c}), K=1")
    flat = V[-1] * enc_out_c
    add(f"encoder_fc_mean: ({flat}, {cfg.nz})")
    add(f"encoder_fc_logvar: ({flat}, {cfg.nz})")

    add("------------Decoder------------")
    fc1_out_c = F[-1] // cfg.reduce_rate
    add(f"decoder_fc1: ({cfg.z_total_dim}, {V[-1] * fc1_out_c})")
    if cfg.reduce_dim > 0:
        add(f"decoder_1x1conv: ({V[-1]}, {F[-1]}), K=1")
    for i, (fin, fout) in enumerate(model._decoder_plan()):
        add(f"decoder_layer{i}: ({V[-(i + 2)]}, {fout}), K={K}  [in {fin}ch @ {V[-(i + 1)]}v]")
    last = model._decoder_plan()[-1][1]
    last_out = last // 2 if (cfg.use_res_block_dec and cfg.affine) else last
    add(f"decoder_output: ({V[0]}, {cfg.nn_input_channel}), K={K}  [in {last_out + ncond}ch]")

    add("----------[Discriminator]----------")
    Vd = ctx.level_sizes_d
    c = cfg.nn_input_channel + ncond
    for i in range(len(ctx.down_d)):
        add(f"discriminator_layer{i}: ({Vd[i + 1]}, {F[i]}), K={cfg.Kd}  [in {c}ch @ {Vd[i]}v]")
        c = F[i]
    # final pred conv uses the VAE poly order (lib/models.py:676 quirk kept)
    add(f"discriminator_pred: ({Vd[len(ctx.down_d)]}, 1), K={K}")

    if params is not None:
        add("----------[Parameters]----------")
        for group in ("cond_pose", "cond_clo", "generator", "discriminator"):
            add(f"{group}: {_count(params[group]):,}")
        add(f"total: {_count(params):,}")
    return "\n".join(lines)
