"""The GAN train step and the eval step.

Counterpart of `cape_tpu.train.step`: one generator forward, three
discriminator applications, both players' losses, ONE backward pass and
both players' updates per step. The losses are blocked per player, so the
gradient of loss_g + loss_d is exactly the two-player gradient set: the G
loss sees the discriminator through detached parameters, and the D loss
sees detached generator outputs and condition embeddings (`.detach()`
where JAX writes `stop_gradient`). JAX's XLA merges the forwards of
d_fake_for_g and d_fake_for_d (the same computation in the forward pass);
eager PyTorch runs all three discriminator forwards.
"""

from __future__ import annotations

import dataclasses

import torch

from cape_tpu_torch import losses
from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.ops.sparse import GraphContext
from cape_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer (its state) and the number
    of steps taken. train_step updates all three in place."""

    model: CAPE
    tx: Optimizer
    step: int = 0


def gan_losses(model: CAPE, cfg: CAPEConfig, ctx: GraphContext, batch: dict, eps):
    """(loss_g + loss_d, metrics) with per-player gradient blocking.
    batch: disp_g/pose_g/clo_g (G samples), disp_d/pose_d/clo_d (D's real
    samples); eps [B, nz] is the reparameterization noise."""
    y_g, y2_g = model.embed_conditions(batch["pose_g"], batch["clo_g"])
    y_d, y2_d = model.embed_conditions(batch["pose_d"], batch["clo_d"])
    x_hat, z_mean, z_logvar, _ = model.generate(ctx, batch["disp_g"], y_g, y2_g, eps)

    d_fake_for_g = model.discriminate(ctx, x_hat, y_g, y2_g, detach_params=True)
    d_real = model.discriminate(ctx, batch["disp_d"], y_d.detach(), y2_d.detach())
    d_fake_for_d = model.discriminate(ctx, x_hat.detach(), y_g.detach(), y2_g.detach())

    gt = batch["disp_g"].to(x_hat.dtype)
    mask = ctx.loss_mask if ctx.loss_mask.dim() > 0 else None
    recon = losses.reconstruction_loss(x_hat, gt, mask=mask, kind=cfg.loss)
    kl = losses.kl_loss(z_mean, z_logvar)
    edge = losses.edge_loss(x_hat, gt, ctx.edge_op)
    gan_g = losses.gan_generator_loss(d_fake_for_g)
    gan_d = losses.gan_discriminator_loss(d_real, d_fake_for_d)
    reg_g = losses.regularization_scale(cfg.regularization) * losses.generator_fc_l2(model.params)

    loss_g = (
        cfg.lambda_gan * gan_g
        + cfg.lambda_recon * recon
        + cfg.lambda_edge * edge
        + cfg.lambda_latent * kl
        + reg_g
    )
    loss_d = cfg.lambda_gan * gan_d  # reg_d == 0 in the reference
    metrics = {
        "loss_g": loss_g, "loss_d": loss_d, "recon": recon, "kl": kl,
        "edge": edge, "gan_g": gan_g, "gan_d": gan_d, "reg_g": reg_g,
    }
    return loss_g + loss_d, metrics


def train_step(state: TrainState, ctx: GraphContext, batch: dict, eps) -> tuple[dict, dict]:
    """One GAN step: gradients of both players from one backward pass,
    the optimizer's updates added to the parameters in place. Returns
    (metrics as detached 0-d tensors, the updates by parameter path); no
    host sync. The updates are what a comparison with optax reads: at a
    small lr, p_after - p_before is rounded to a few float32 ulps of p."""
    model = state.model
    named = dict(model.named_parameters())
    total, metrics = gan_losses(model, model.cfg, ctx, batch, eps)
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    grads = {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(named.items(), grads)
    }
    updates = state.tx.update(grads)
    with torch.no_grad():
        for n, p in named.items():
            p.add_(updates[n].to(p.dtype))
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}, updates


@torch.no_grad()
def eval_step(model: CAPE, cfg: CAPEConfig, ctx: GraphContext, batch: dict, eps):
    """(prediction [B, V, 3] f32, per-sample metrics {recon, kl, edge}, each
    [B] f32): reconstruction through the sampled-z path, as the
    reference's `predict`. Per sample, so that a caller can drop the pad
    rows of a padded tail batch."""
    y, y2 = model.embed_conditions(batch["pose"], batch["clo"])
    x_hat, z_mean, z_logvar, _ = model.generate(ctx, batch["disp"], y, y2, eps)
    gt = batch["disp"].to(x_hat.dtype)
    mask = ctx.loss_mask if ctx.loss_mask.dim() > 0 else None
    metrics = {
        "recon": losses.reconstruction_loss_per_sample(x_hat, gt, mask=mask, kind=cfg.loss),
        "kl": losses.kl_loss_per_sample(z_mean, z_logvar),
        "edge": losses.edge_loss_per_sample(x_hat, gt, ctx.edge_op),
    }
    return x_hat.float(), {k: v.float() for k, v in metrics.items()}
