"""Write the golden files `chip_smoke.py` holds the PyTorch port to, from the
JAX package on the CPU, for parameters made by the port.

    JAX_PLATFORMS=cpu python tests/make_torch_golden.py [serve] [train]

Both use the flagship preset at full width, f32, on JAX's plain banded
route (use_pallas=False, which tests/test_ops.py holds equal to the Pallas
v3 route), with the port's parameters from torch.Generator seed 0 on the
CPU, sent to JAX through the bridge. Each file keeps a fingerprint of the
parameters (per-leaf sums), so that a reader can tell a parameter mismatch
from a compute mismatch.

serve -> tests/data/torch_golden_flagship.npz: JAX decodes 32 latent rows
(z, pose, clothing type from numpy default_rng(0)) at batch 32 and the file
keeps the inputs and the first 8 meshes in natural vertex order.

train -> tests/data/torch_golden_train.npz: two GAN train steps at batch 32
(SGD momentum with the preset's warmup, so step 1's lr is 0 and step 2's
update carries both steps' gradients). The steps are `build_train_step`'s
body with the optimizer's updates returned: at the warmup's small lr,
p_after - p_before would be rounded to a few float32 ulps of p. The batches follow a recipe the
port replays: synthetic_bodydata(n_train=512, n_test=64, seed=cfg.seed),
RCM vertex order, BatchStream seeds cfg.seed and cfg.seed + 1. The noise
eps [2, 32, nz] (numpy default_rng(1)) is stored. The file keeps the eight
metrics of both steps, per-leaf summaries (sum, sum of squares, max|.|) of
the step-2 update of every leaf, and the whole step-2 update of every leaf
under 64K elements.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
OUT = os.path.join(ROOT, "tests", "data", "torch_golden_flagship.npz")
OUT_TRAIN = os.path.join(ROOT, "tests", "data", "torch_golden_train.npz")
B, KEEP = 32, 8
N_TRAIN, N_TEST, STEPS = 512, 64, 2
WHOLE_MAX = 64 * 1024   # leaves with fewer elements are stored whole
METRICS = ("loss_g", "loss_d", "recon", "kl", "edge", "gan_g", "gan_d", "reg_g")


def fingerprint(state_dict) -> tuple[list[str], np.ndarray]:
    """(sorted keys, float64 sum of each leaf) of a port state dict."""
    keys = sorted(state_dict)
    return keys, np.array([state_dict[k].double().sum().item() for k in keys])


def golden_inputs(cfg):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((B, cfg.nz)).astype(np.float32)
    pose = (0.5 * rng.standard_normal((B, cfg.cond_dim))).astype(np.float32)
    clo = np.eye(cfg.cond2_dim, dtype=np.float32)[rng.integers(0, cfg.cond2_dim, B)]
    return z, pose, clo


def train_eps(cfg) -> np.ndarray:
    return np.random.default_rng(1).standard_normal((STEPS, B, cfg.nz)).astype(np.float32)


def update_summary(delta: np.ndarray) -> np.ndarray:
    """[sum, sum of squares, max|.|] of an update, in float64."""
    d = delta.astype(np.float64)
    return np.array([d.sum(), np.square(d).sum(), np.abs(d).max()])


def make_serve(model, params):
    from cape_tpu.apps.inference import InferenceEngine as JaxEngine
    from cape_tpu.apps.main import build_context as jax_build_context
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu.models.cape import CAPE as JaxCAPE

    keys, sums = fingerprint(model.state_dict())
    jcfg = jax_load_config(PRESET, use_pallas=False)
    engine = JaxEngine(JaxCAPE(jcfg), jax_build_context(jcfg), params, batch_size=B)
    z, pose, clo = golden_inputs(model.cfg)
    y, y2 = engine.encode_only_condition(pose, clo)
    disp = engine.decode(np.concatenate([z, y, y2], -1), y, y2)
    assert disp.shape == (B, 6890, 3) and np.isfinite(disp).all()
    np.savez_compressed(
        OUT, z=z, pose=pose, clo=clo, disp=disp[:KEEP].astype(np.float32),
        param_keys=np.array(keys), param_sums=sums,
    )
    print(f"wrote {OUT}: disp[:{KEEP}] max|ref| {np.abs(disp[:KEEP]).max():.6g}")


def make_train(model, params):
    import jax
    import jax.numpy as jnp

    from cape_tpu.apps.main import build_context as jax_build_context
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu.data.loader import BatchStream
    from cape_tpu.data.synthetic import synthetic_bodydata
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu.train.optim import TrainState, build_optimizer, create_train_state
    from cape_tpu.train.step import _gan_losses
    from cape_tpu_torch.core.bridge import _flatten

    class EpsCAPE(JaxCAPE):
        """The reparameterization noise comes in through the rng argument."""

        def sample_z(self, rng, z_mean, z_logvar):
            return z_mean + jnp.exp(0.5 * jnp.clip(z_logvar, -30.0, 30.0)) * rng

    keys, sums = fingerprint(model.state_dict())
    jcfg = jax_load_config(PRESET, use_pallas=False, batch_size=B)
    ctx = jax_build_context(jcfg)
    data = synthetic_bodydata(n_train=N_TRAIN, n_test=N_TEST, num_verts=6890, seed=jcfg.seed)
    steps_per_epoch = len(data.disp_train) // B
    tx, _, _ = build_optimizer(jcfg, steps_per_epoch)
    state = create_train_state(params, tx)
    jmodel = EpsCAPE(jcfg)

    @jax.jit
    def step_fn(state, ctx, batch, eps):
        # cape_tpu.train.step.build_train_step, returning the updates too
        (_, metrics), grads = jax.value_and_grad(
            lambda p: _gan_losses(jmodel, jcfg, p, ctx, batch, eps), has_aux=True
        )(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype), state.params, updates)
        return TrainState(step=state.step + 1, params=new, opt_state=opt_state), metrics, updates

    eps = train_eps(jcfg)
    metrics = np.zeros((STEPS, len(METRICS)))
    n = len(data.disp_train)
    sg, sd = BatchStream(n, B, jcfg.seed), BatchStream(n, B, jcfg.seed + 1)
    disp = data.disp_train[:, ctx.vertex_perm]
    for i in range(STEPS):
        ig, idd = sg.next_indices(), sd.next_indices()
        batch = {
            "disp_g": disp[ig], "pose_g": data.pose_train[ig], "clo_g": data.clo_train[ig],
            "disp_d": disp[idd], "pose_d": data.pose_train[idd], "clo_d": data.clo_train[idd],
        }
        state, m, updates = step_fn(state, ctx, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jnp.asarray(eps[i]))
        metrics[i] = [float(m[k]) for k in METRICS]
        print(f"step {i + 1}: " + " ".join(f"{k}={v:.6g}" for k, v in zip(METRICS, metrics[i])))
    deltas = _flatten(jax.device_get(updates))
    assert sorted(deltas) == keys and np.isfinite(metrics).all()
    whole = {f"update/{k}": deltas[k] for k in keys if deltas[k].size < WHOLE_MAX}
    np.savez_compressed(
        OUT_TRAIN, metric_names=np.array(METRICS), metrics=metrics, eps=eps,
        seed=jcfg.seed, n_train=N_TRAIN, n_test=N_TEST, steps_per_epoch=steps_per_epoch,
        param_keys=np.array(keys), param_sums=sums,
        update_summary=np.stack([update_summary(deltas[k]) for k in keys]), **whole,
    )
    print(f"wrote {OUT_TRAIN}: {len(whole)} of {len(keys)} leaves whole, "
          f"{os.path.getsize(OUT_TRAIN)} bytes")


def main(argv=None):
    which = set(sys.argv[1:] if argv is None else argv) or {"serve", "train"}
    sys.path.insert(0, ROOT)
    import jax
    import torch

    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE

    cfg = load_config(PRESET)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), build_context(cfg))
    params = jax.tree_util.tree_map(jax.numpy.asarray, to_jax_params(model))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    if "serve" in which:
        make_serve(model, params)
    if "train" in which:
        make_train(model, params)


if __name__ == "__main__":
    main()
