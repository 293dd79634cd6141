"""The CAPE model: condition nets, encoder, decoder and discriminator.

Counterpart of `cape_tpu.models.cape`, every family it builds: plain or
residual encoder blocks; plain deconv, GraphCMR group-norm or affine
decoder blocks; folded or materialized conditions; the fused (L~@U)
decoder; recomputed block activations (remat); banded, ELL and dense
operators. Parameters live in the module under the JAX package's key paths
(`generator.decoder.layer0.gn0.gamma`), so `core.bridge` maps a JAX param
tree or checkpoint onto `load_state_dict` without renaming. They are
trainable; serving runs under `torch.inference_mode()` (apps.inference).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.core.params import (
    ACTIVATIONS,
    conv_weight,
    dense_apply,
    dense_init,
    leaky_relu,
    split,
)
from cape_tpu_torch.core.spans import span
from cape_tpu_torch.models import blocks
from cape_tpu_torch.ops.banded import padded_size
from cape_tpu_torch.ops.cheb import cheb_conv, cheb_conv_folded
from cape_tpu_torch.ops.sparse import GraphContext
from cape_tpu_torch.parallel import mesh2d

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _pad_vertex_rows(x: torch.Tensor) -> torch.Tensor:
    """Pad the vertex axis of [..., V, C] up to the next 128-multiple."""
    P = padded_size(x.shape[-2])
    return x if P == x.shape[-2] else F.pad(x, (0, 0, 0, P - x.shape[-2]))


def _cond_hidden_width(y_dim: int, nz_cond: int) -> int:
    """Hidden width heuristic of the 2-layer condition net."""
    if nz_cond < y_dim // 2:
        return y_dim // 2
    if nz_cond < y_dim * 2:
        return y_dim
    return nz_cond // 2


def unsupported(cfg: CAPEConfig) -> list[str]:
    """The parts of `cfg` this port does not cover."""
    if cfg.compute_dtype not in DTYPES:
        return [f"compute_dtype={cfg.compute_dtype!r} (float32, bfloat16 or float16)"]
    return []


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: dict keys become module
    and parameter names, so state-dict keys are the dotted key paths."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> dict:
        out = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


class CAPE(nn.Module):
    def __init__(self, config: CAPEConfig):
        super().__init__()
        missing = unsupported(config)
        if missing:
            raise NotImplementedError(
                "not ported to cape_tpu_torch yet: " + "; ".join(missing)
            )
        self.cfg = config
        self.act = ACTIVATIONS[config.activation]
        self.dtype = DTYPES[config.compute_dtype]

    def _block(self, fn):
        """With cfg.remat, `fn` runs under activation checkpointing while
        autograd records: the backward pass recomputes the block's
        activations (and launches its kernels again) instead of storing
        them."""
        if not self.cfg.remat:
            return fn

        def run(*args):
            if not torch.is_grad_enabled():
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False)

        return run

    @property
    def _affine_dec(self) -> bool:
        return self.cfg.use_res_block_dec and self.cfg.affine

    @property
    def _cmr_dec(self) -> bool:
        return self.cfg.use_res_block_dec and not self.cfg.affine

    # ------------------------------------------------------------- channels
    def _encoder_channels(self) -> list[int]:
        cfg = self.cfg
        c = cfg.nn_input_channel
        if cfg.cond_encoder:
            c += cfg.nz_cond + cfg.nz_cond2
        return [c] + list(cfg.channels)  # chans[i] = input channels of layer i

    def _decoder_plan(self) -> list[tuple[int, int]]:
        """[(fin, fout_block)] per decoder block, after the cond concat."""
        cfg = self.cfg
        ncond = cfg.nz_cond + cfg.nz_cond2
        F_ = cfg.channels
        c = F_[-1] + ncond
        plan = []
        for i in range(cfg.num_conv_layers):
            fout = F_[-(i + 1)]
            plan.append((c, fout))
            c = (fout // 2 if self._affine_dec else fout) + ncond  # affine: fout // 2
        return plan

    # ------------------------------------------------------------------ init
    def init_params(self, key, ctx: GraphContext) -> "CAPE":
        """Draw every parameter, the discriminator's included, on the CPU and
        register them on this module. `key` is a `core.prng` key: the key
        tree is JAX's (split(key, 64), taken in this order, and each block's
        own split), so PRNGKey(s) gives the JAX package's init_params(
        PRNGKey(s)) values. A torch.Generator instead draws the test form
        (`core.params`), which is not JAX's."""
        cfg = self.cfg
        keys = iter(split(key, 64))
        nxt = lambda: next(keys)
        pose_hidden = _cond_hidden_width(cfg.cond_dim, cfg.nz_cond)
        cond_pose = {
            "fc1": dense_init(nxt(), cfg.cond_dim, pose_hidden),
            "fc2": dense_init(nxt(), pose_hidden, cfg.nz_cond),
        }
        if cfg.n_layer_cond == 1:
            cond_clo = {"fc1": dense_init(nxt(), cfg.cond2_dim, cfg.nz_cond2)}
        else:
            clo_hidden = _cond_hidden_width(cfg.cond2_dim, cfg.nz_cond2)
            cond_clo = {
                "fc1": dense_init(nxt(), cfg.cond2_dim, clo_hidden),
                "fc2": dense_init(nxt(), clo_hidden, cfg.nz_cond2),
            }

        enc_chans = self._encoder_channels()
        F_, K = cfg.channels, cfg.K
        encoder: dict = {}
        enc_init = blocks.res_block_init if cfg.use_res_block else blocks.conv_block_init
        for i in range(cfg.num_conv_layers):
            encoder[f"layer{i}"] = enc_init(nxt(), K, enc_chans[i], F_[i])
        p_last = ctx.level_sizes[-1]
        enc_out_c = F_[-1]
        if cfg.reduce_dim > 0:
            enc_out_c = F_[-1] // cfg.reduce_rate
            encoder["reduce"] = blocks.conv1x1_init(nxt(), F_[-1], enc_out_c)
        encoder["fc_mean"] = dense_init(nxt(), p_last * enc_out_c, cfg.nz)
        encoder["fc_var"] = dense_init(nxt(), p_last * enc_out_c, cfg.nz)

        decoder: dict = {}
        fc1_out_c = F_[-1] // cfg.reduce_rate
        decoder["fc1"] = dense_init(nxt(), cfg.z_total_dim, p_last * fc1_out_c)
        if cfg.reduce_dim > 0:
            decoder["expand"] = blocks.conv1x1_init(nxt(), fc1_out_c, F_[-1])
        plan = self._decoder_plan()
        dec_init = (blocks.affine_block_init if self._affine_dec
                    else blocks.cmr_block_init if self._cmr_dec else blocks.conv_block_init)
        for i, (fin, fout) in enumerate(plan):
            decoder[f"layer{i}"] = dec_init(nxt(), K, fin, fout)
        ncond = cfg.nz_cond + cfg.nz_cond2
        last_out = plan[-1][1] // 2 if self._affine_dec else plan[-1][1]
        decoder["out"] = {
            "w": conv_weight(nxt(), K, last_out + ncond, cfg.nn_input_channel),
            "b": torch.full((ctx.level_sizes[0], cfg.nn_input_channel), 0.1),
        }

        disc: dict = {}
        c = cfg.nn_input_channel + ncond
        for i in range(len(ctx.level_sizes_d) - 1):
            disc[f"layer{i}"] = blocks.conv_block_init(nxt(), cfg.Kd, c, F_[i])
            c = F_[i]
        # the final pred conv uses the VAE poly order, as in the reference
        disc["pred"] = {"w": conv_weight(nxt(), K, c, 1)}

        tree = {
            "cond_pose": cond_pose,
            "cond_clo": cond_clo,
            "generator": {"encoder": encoder, "decoder": decoder},
            "discriminator": disc,
        }
        for k, v in tree.items():
            self.add_module(k, ParamTree(v))
        return self

    @property
    def params(self) -> dict:
        """The parameters as a nested dict in the JAX layout (live tensors)."""
        return {k: m.tree() for k, m in self.named_children()}

    # ------------------------------------------------------------ condition
    def embed_conditions(self, pose: torch.Tensor, clo: torch.Tensor):
        """(pose [B,126], clo [B,4]) -> (y [B,nz_cond], y2 [B,nz_cond2])."""
        params = self.params
        pose = pose.to(self.dtype)
        clo = clo.to(self.dtype)
        p = params["cond_pose"]
        y = dense_apply(p["fc1"], pose, activation=leaky_relu)
        y = dense_apply(p["fc2"], y)
        c = params["cond_clo"]
        if "fc2" in c:
            y2 = dense_apply(c["fc1"], clo, activation=leaky_relu)
            y2 = dense_apply(c["fc2"], y2)
        else:
            y2 = dense_apply(c["fc1"], clo)
        return y, y2

    # --------------------------------------------------------------- encoder
    def encode(self, ctx: GraphContext, x, y, y2):
        """x [B,V,3] -> (z_mean, z_logvar) [B,nz], named `model.encode` in
        a running profiler's trace (`core.spans.span`)."""
        with span("model.encode"):
            return self._encode(ctx, x, y, y2)

    def _encode(self, ctx: GraphContext, x, y, y2):
        cfg = self.cfg
        enc = self.params["generator"]["encoder"]
        x = x.to(self.dtype)
        if ctx.padded:
            x = _pad_vertex_rows(x)  # enter the padded layout
        fold = cfg.fold_conditions and cfg.cond_encoder
        if cfg.cond_encoder and not fold:
            x = blocks.concat_conditions(x, y, y2)
        for i in range(cfg.num_conv_layers):
            p = enc[f"layer{i}"]
            lap, down = ctx.lap[i], ctx.down[i]
            if fold and i == 0:
                # the conditions enter at the input concat only: folded
                # into the first conv (ops.cheb.cheb_conv_folded)
                form = (blocks.res_block_folded_apply if cfg.use_res_block
                        else blocks.conv_block_folded_apply)
                blk = self._block(lambda p, x, y, y2, lap=lap, down=down, form=form:
                                  form(p, x, [y, y2], lap, down, self.act))
                x = blk(p, x, y, y2)
                continue
            form = blocks.res_block_apply if cfg.use_res_block else blocks.conv_block_apply
            blk = self._block(lambda p, x, lap=lap, down=down, form=form:
                              form(p, x, lap, down, self.act))
            x = blk(p, x)
        if ctx.padded:
            x = x[:, : ctx.level_sizes[-1], :]  # exit the padded layout
        if cfg.reduce_dim > 0:
            x = blocks.conv1x1_apply(enc["reduce"], x, ctx.lap[-1])
        x = x.reshape(x.shape[0], -1)
        return dense_apply(enc["fc_mean"], x), dense_apply(enc["fc_var"], x)

    # --------------------------------------------------------------- decoder
    def decode(self, ctx: GraphContext, z_total, y, y2):
        """[z | y | y2] [B,z_total] -> verts [B,V,3]."""
        cfg = self.cfg
        dec = self.params["generator"]["decoder"]
        z_total = z_total.to(self.dtype)
        x = dense_apply(dec["fc1"], z_total, activation=leaky_relu)
        x = x.reshape(x.shape[0], ctx.level_sizes[-1], -1)
        if cfg.reduce_dim > 0:
            x = blocks.conv1x1_apply(dec["expand"], x, ctx.lap[-1])
        if ctx.padded:
            x = _pad_vertex_rows(x)  # enter the padded layout

        # folding is exact for the linear block forms (deconv, affine); the
        # CMR block's group norms see the condition channels, so that path
        # keeps the materialized concat
        fold = cfg.fold_conditions and not self._cmr_dec
        if not fold:
            x = blocks.concat_conditions(x, y, y2)
        # the fused unpool-conv: the composed L~@U operators replace the
        # separate unpool and fine-level conv (ops.cheb.cheb_conv_up)
        fuse = cfg.fuse_decoder and fold and cfg.K == 2
        if fuse and len(ctx.lap_up) == 0:
            raise ValueError(
                "cfg.fuse_decoder=True needs the composed L~@U operators: "
                "build the GraphContext with build_fused=True"
            )
        for i in range(cfg.num_conv_layers):
            p = dec[f"layer{i}"]
            lap, up = ctx.lap[-(i + 2)], ctx.up[-(i + 1)]
            if fold:
                if fuse:
                    lu = ctx.lap_up[-(i + 1)]
                    if self._affine_dec:
                        blk = lambda p, x, y, y2, up=up, lu=lu: blocks.affine_block_fused_apply(
                            p, x, [y, y2], up, lu)
                    else:
                        blk = lambda p, x, y, y2, up=up, lu=lu: blocks.deconv_block_fused_apply(
                            p, x, [y, y2], up, lu, self.act)
                elif self._affine_dec:
                    blk = lambda p, x, y, y2, lap=lap, up=up: blocks.affine_block_folded_apply(
                        p, x, [y, y2], lap, up)
                else:
                    blk = lambda p, x, y, y2, lap=lap, up=up: blocks.deconv_block_folded_apply(
                        p, x, [y, y2], lap, up, self.act)
                x = self._block(blk)(p, x, y, y2)
                continue
            if self._affine_dec:
                blk = lambda p, x, lap=lap, up=up: blocks.affine_block_apply(p, x, lap, up)
            elif self._cmr_dec:
                # padded layout: the group-norm statistics run over the
                # natural vertex count of the unpooled level only
                nv = lap.n_rows if ctx.padded else None
                blk = lambda p, x, lap=lap, up=up, nv=nv: blocks.cmr_block_apply(
                    p, x, lap, up, n_valid=nv)
            else:
                blk = lambda p, x, lap=lap, up=up: blocks.deconv_block_apply(
                    p, x, lap, up, self.act)
            x = self._block(blk)(p, x)
            x = blocks.concat_conditions(x, y, y2)
        if fold:
            x = cheb_conv_folded(x, [y, y2], ctx.lap[0], dec["out"]["w"])
        else:
            x = cheb_conv(x, ctx.lap[0], dec["out"]["w"])
        if ctx.padded:
            x = x[:, : ctx.level_sizes[0], :]  # exit the padded layout
        return x + mesh2d.full(dec["out"]["b"]).to(x.dtype)

    # ------------------------------------------------------------- sampling
    @staticmethod
    def sample_z(z_mean, z_logvar, eps):
        """Reparameterization z = mu + sigma * eps, with the JAX package's
        clamp of logvar inside the exp. eps is given by the caller."""
        return z_mean + torch.exp(0.5 * torch.clamp(z_logvar, -30.0, 30.0)) * eps

    def generate(self, ctx: GraphContext, x, y, y2, eps):
        """Full CVAE forward with the caller's noise eps [B, nz]: JAX draws
        it in z_mean's dtype, as the Trainer's draws are (`core.prng`); an
        eps of another dtype is rounded to it. Returns (x_hat, z_mean,
        z_logvar, z)."""
        z_mean, z_logvar = self.encode(ctx, x, y, y2)
        z = self.sample_z(z_mean, z_logvar, eps.to(z_mean.dtype))
        x_hat = self.decode(ctx, torch.cat([z, y, y2], dim=-1), y, y2)
        return x_hat, z_mean, z_logvar, z

    # --------------------------------------------------------- discriminator
    def discriminate(self, ctx: GraphContext, x, y, y2, detach_params: bool = False):
        """Per-vertex real/fake logits on the coarsest ds2 level [B, 431, 1].
        detach_params=True runs on detached discriminator parameters (the G
        loss's view of D: JAX's stop_gradient on params['discriminator']).
        The Kd=3 layer convs take the plain path; the final `pred` conv has
        the VAE's order K (the reference's quirk), so at batch 32 the gate
        sends it to the kernel."""
        disc = self.params["discriminator"]
        if detach_params:
            disc = {k: {n: mesh2d.detach(t) for n, t in p.items()} for k, p in disc.items()}
        x = x.to(self.dtype)
        if ctx.padded:
            x = _pad_vertex_rows(x)
        fold = self.cfg.fold_conditions
        if not fold:
            x = blocks.concat_conditions(x, y, y2)
        for i in range(len(ctx.down_d)):
            lap, down = ctx.lap_d[i], ctx.down_d[i]
            p = disc[f"layer{i}"]
            if fold and i == 0:
                blk = self._block(lambda p, x, y, y2, lap=lap, down=down:
                                  blocks.conv_block_folded_apply(p, x, [y, y2], lap, down, self.act))
                x = blk(p, x, y, y2)
            else:
                blk = self._block(lambda p, x, lap=lap, down=down:
                                  blocks.conv_block_apply(p, x, lap, down, self.act))
                x = blk(p, x)
        x = cheb_conv(x, ctx.lap_d[-1], disc["pred"]["w"])
        if ctx.padded:
            x = x[:, : ctx.level_sizes_d[-1], :]  # exit the padded layout
        return x
