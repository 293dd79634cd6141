"""Loss functions for CAPE training.

Counterpart of `cape_tpu.losses`, term for term: masked L1/huber/L2
reconstruction, the KL latent loss with the clamped exp, the edge-length
loss through the banded edge operator, label-smoothed sigmoid-CE GAN losses
and the FC-kernel L2 regularization with the reference's effective
coefficient reg^2/2 (see the JAX module's notes on the kept quirks). The
face and vertex normal losses are not on the train step and are not ported.
"""

from __future__ import annotations

import torch


def reconstruction_loss_per_sample(pred, gt, mask=None, kind: str = "l1",
                                   huber_delta: float = 0.1):
    """Per-sample weighted-mean reconstruction loss, shape [B]. mask: None
    or per-vertex weights [V], with sum(w * l) / sum(w) semantics."""
    diff = pred - gt
    if kind == "l1":
        el = diff.abs()
    elif kind == "huber":
        a = diff.abs()
        el = torch.where(a <= huber_delta, 0.5 * a * a, huber_delta * (a - 0.5 * huber_delta))
    else:  # l2
        el = diff * diff
    non_batch = tuple(range(1, el.dim()))
    if mask is None:
        return el.mean(dim=non_batch)
    w = mask.to(el.dtype)[None, :, None].expand(el.shape)
    return (w * el).sum(dim=non_batch) / torch.clamp(w.sum(dim=non_batch), min=1e-12)


def reconstruction_loss(pred, gt, mask=None, kind: str = "l1", huber_delta: float = 0.1):
    """Batch-mean reconstruction loss."""
    return reconstruction_loss_per_sample(pred, gt, mask, kind, huber_delta).mean()


def kl_loss_per_sample(z_mean, z_logvar):
    """Per-sample KL(q(z|x) || N(0, I)), shape [B]; the exp is clamped as in
    CAPE.sample_z, the linear logvar term keeps its gradient."""
    return -0.5 * torch.sum(
        1.0 + z_logvar - z_mean.square() - torch.exp(torch.clamp(z_logvar, -30.0, 30.0)),
        dim=-1,
    )


def kl_loss(z_mean, z_logvar):
    return kl_loss_per_sample(z_mean, z_logvar).mean()


def edge_loss_per_sample(pred, gt, edge_op):
    """Per-sample mean edge-difference length, shape [B]. The eps inside
    the sqrt keeps the gradient finite at an exactly-zero difference."""
    edge_diff = edge_op(pred - gt)
    return torch.sqrt(edge_diff.square().sum(dim=-1) + 1e-12).mean(dim=-1)


def edge_loss(pred, gt, edge_op):
    return edge_loss_per_sample(pred, gt, edge_op).mean()


def edge_loss_indexed(pred, gt, edges):
    """Index-table variant: edges [E, 2] integer vertex pairs."""
    d = pred - gt
    edge_diff = d.index_select(-2, edges[:, 0].long()) - d.index_select(-2, edges[:, 1].long())
    return torch.linalg.vector_norm(edge_diff, dim=-1).mean()


def _sigmoid_ce(logits, labels):
    # numerically stable sigmoid cross-entropy with soft labels
    return torch.mean(
        torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


def gan_generator_loss(d_logits_fake, smooth: float = 0.1):
    """G wants D(fake) -> 'real', with label smoothing."""
    return _sigmoid_ce(d_logits_fake, (1.0 - smooth) * torch.ones_like(d_logits_fake))


def gan_discriminator_loss(d_logits_real, d_logits_fake, smooth: float = 0.1):
    """Soft labels 0.9 / 0.1."""
    real = _sigmoid_ce(d_logits_real, (1.0 - smooth) * torch.ones_like(d_logits_real))
    fake = _sigmoid_ce(d_logits_fake, smooth * torch.ones_like(d_logits_fake))
    return real + fake


def generator_fc_l2(params: dict) -> torch.Tensor:
    """Sum of squared FC kernels the reference regularizes: encoder
    fc_mean / fc_var and decoder fc1."""
    gen = params["generator"]
    terms = [
        gen["encoder"]["fc_mean"]["kernel"],
        gen["encoder"]["fc_var"]["kernel"],
        gen["decoder"]["fc1"]["kernel"],
    ]
    return sum(w.square().sum() for w in terms)


def regularization_scale(regularization: float) -> float:
    """Effective coefficient of the reference's double application:
    reg * (reg * sum(w^2) / 2)."""
    return 0.5 * regularization * regularization
