"""The flagship set-up of the lab (`tools.perf_lab`) and the endurance run
(`tools.endurance`): the CAPE-affineconv_nz64_pose32_clotype32 model on
the SMPL template's pyramids.

Counterpart of the JAX package's `__graft_entry__._flagship_setup`, with
the same widths (`FLAGSHIP`); the parameters are JAX's from PRNGKey(0),
as the JAX lab draws them, unless `init_seed` says otherwise.
"""

from __future__ import annotations

from cape_tpu_torch.core import prng
from cape_tpu_torch.core.config import CAPEConfig

# the flagship's fields that differ from CAPEConfig's defaults
FLAGSHIP = dict(
    name="flagship", nz=64, nz_cond=32, nz_cond2=32, nf=64,
    use_res_block=False, use_res_block_dec=True, affine=True,
    reduce_dim=64, lambda_edge=1.0, batch_size=16,
)


def flagship_config(**overrides) -> CAPEConfig:
    return CAPEConfig(**{**FLAGSHIP, **overrides})


def flagship_setup(compute_dtype: str = "float32", device="cpu", init_seed: int | None = 0,
                   **overrides):
    """(config, model on `device` with the parameters of
    init_params(PRNGKey(init_seed)), graph context on `device`) of the
    flagship; init_seed None takes cfg.seed, as JAX's Trainer.fit does.
    `overrides` replace config fields."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.models.cape import CAPE

    cfg = flagship_config(compute_dtype=compute_dtype, **overrides)
    ctx = build_context(cfg, device=device)
    key = prng.PRNGKey(cfg.seed if init_seed is None else init_seed)
    model = CAPE(cfg).init_params(key, ctx).to(device)
    return cfg, model, ctx
