"""Write the golden files `chip_smoke.py` holds the PyTorch port to, from the
JAX package on the CPU, for parameters made by the port.

    JAX_PLATFORMS=cpu python tests/make_torch_golden.py [serve] [train] [demo] [families] [bf16]

Serve and train use the flagship preset, demo the nz18 release preset, each
at full width, f32, on JAX's plain banded
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

demo -> tests/data/torch_golden_demo.npz: the nz18 release preset at batch
32. JAX's DemoSuite (seed cfg.seed, 5 samples, no SMPL file) runs
test_model on synthetic_bodydata(n_train=96, n_test=64, seed=cfg.seed);
the file keeps its three errors and the first two exported reconstructions
(full bodies, read back from the OBJ files). A fresh suite's
sample_gmm_prior(n=2) gives two GMM-prior bodies, and its latents (the
shipped prior's GMM.sample of the suite's first key) are kept. Last, the
server's draw: sample_np(default_rng(3), 4) of the prior, decoded under
the first demo pose and the first clothing type; the file keeps z and the
first two meshes.

families -> tests/data/torch_golden_families.npz: the CMR release preset
(configs/CAPE_nz18_pose24_clotype8_male.yaml, keys "cmr:...") and
configs/default_config.yaml with a name set (residual encoder and CMR
decoder, keys "default:..."), each at batch 32: the decode of the serve
golden's inputs (z, pose, clothing type from default_rng(0)), keeping the
first 8 meshes; the encode of 32 meshes 0.02 * default_rng(2) normal draws
in natural vertex order under the same conditions, keeping z_mean,
z_logvar and the meshes' sum and sum of |.| (so that a reader can tell it
drew the same meshes); and two train steps by the train golden's recipe,
keeping whole updates only of leaves under 4K elements. Last, how far
JAX's own step-2 updates move when every parameter is moved by about one
float32 ulp (p * (1 + 2^-24 * default_rng(3) normal draws)):
`update_spread`, by the measures of chip_smoke.py's hold_updates (see
`update_spread`). A reader holding its updates to this golden cannot ask
for less than that (chip_smoke.py's bound is the larger of 1e-3 and
twice it). And the flagship's decode of the serve golden's inputs in the
natural vertex order (op_mode="ell"; "dense" agrees within 1e-5 *
max|ref|), keys "natural:...", keeping the first 4 meshes: the fc1
layer's output and the encoder's flatten are laid out by the coarsest
level's vertex order, which the banded mode permutes, so the same
parameters decode differently in the ELL and dense modes than in the
banded mode.

bf16 -> tests/data/torch_golden_bf16.npz: the flagship's production
training setting, compute_dtype=bfloat16 (f32 parameters), two GAN steps
by the train golden's recipe (batches at the run's batch size, eps
default_rng(1) [2, batch, nz]; the noise enters in z_mean's dtype, as
JAX's own sample_z draws it), in three configurations, keys "<prefix>:...":
"b32" (batch 32, the kernel route's batch), "b16" (batch 16, JAX's
headline) and "opt" (batch 32 with opt_state_dtype=bfloat16). Each keeps
the eight metrics of both steps and their dtypes, the per-leaf summaries
of the step-2 update, and the same of JAX's f32 steps (f32 compute and
state) on the same inputs; from the two, the bounds a port's bf16 run is
held by (`bf16_bounds`: twice bf16's effect in JAX itself, per metric and
per player's leaves, at least one bf16 ulp of a metric and 1e-3 of a
leaf's max|update|). No whole update is kept.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
OUT = os.path.join(ROOT, "tests", "data", "torch_golden_flagship.npz")
OUT_TRAIN = os.path.join(ROOT, "tests", "data", "torch_golden_train.npz")
PRESET_NZ18 = os.path.join(ROOT, "configs", "CAPE-affineconv_nz18_pose24_clotype8_male.yaml")
OUT_DEMO = os.path.join(ROOT, "tests", "data", "torch_golden_demo.npz")
OUT_FAMILIES = os.path.join(ROOT, "tests", "data", "torch_golden_families.npz")
OUT_BF16 = os.path.join(ROOT, "tests", "data", "torch_golden_bf16.npz")
# the bf16 golden's configurations: key prefix -> (batch, overrides of the
# bf16 run); each is held to the f32 run at its batch
BF16_RUNS = {"b32": (32, {}), "b16": (16, {}), "opt": (32, {"opt_state_dtype": "bfloat16"})}
# the least bound of a leaf's step-2 update, relative to its max|update|:
# the f32 train golden's
UPDATE_FLOOR = 1e-3
# the families golden's presets: key prefix -> (preset, overrides)
FAMILIES = {
    "cmr": (os.path.join(ROOT, "configs", "CAPE_nz18_pose24_clotype8_male.yaml"), {}),
    "default": (os.path.join(ROOT, "configs", "default_config.yaml"),
                {"name": "families_default"}),
}
FAMILIES_WHOLE_MAX = 4 * 1024
KEEP_NATURAL = 4
# the demo golden's data, prior draws and mesh count
DEMO_TRAIN, DEMO_TEST, DEMO_KEEP, GMM_N, GMM_SEED, SERVE_N = 96, 64, 2, 2, 3, 4
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


def encode_inputs() -> np.ndarray:
    """The families golden's 32 meshes to encode, natural vertex order."""
    return (0.02 * np.random.default_rng(2).standard_normal((B, 6890, 3))).astype(np.float32)


def train_eps(cfg, batch_size: int = B) -> np.ndarray:
    return np.random.default_rng(1).standard_normal((STEPS, batch_size, cfg.nz)).astype(np.float32)


def update_summary(delta: np.ndarray) -> np.ndarray:
    """[sum, sum of squares, max|.|] of an update, in float64."""
    d = delta.astype(np.float64)
    return np.array([d.sum(), np.square(d).sum(), np.abs(d).max()])


def update_spread(ref: dict, other: dict, whole_max: int) -> float:
    """How far the updates `other` are from `ref`, by the measures of
    chip_smoke.py's hold_updates, relative to each leaf's max|ref|: the
    error of max|.|, of the sum of squares (over twice it), of the sum
    (over sqrt(n * sum of squares)) and, for a leaf under whole_max
    elements, of its elements once the max(4, n / 10^4) largest, which
    hold_updates lets through as ties, are set aside. The largest over the
    leaves."""
    worst = 0.0
    for k, u in ref.items():
        u, v = u.astype(np.float64), other[k].astype(np.float64)
        r_max, r_sq = np.abs(u).max(), np.square(u).sum()
        errs = [abs(np.abs(v).max() - r_max) / r_max, abs(np.square(v).sum() - r_sq) / (2 * r_sq),
                abs(v.sum() - u.sum()) / np.sqrt(u.size * r_sq)]
        ties = max(4, u.size // 10_000)
        if ties < u.size < whole_max:
            errs.append(np.sort((np.abs(v - u) / r_max).ravel())[-ties - 1])
        worst = max(worst, *errs)
    return float(worst)


def bf16_ulp_rel(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v|, relative to |v| (2^-8 to 2^-7)."""
    a = np.abs(np.asarray(v, np.float64))
    return 2.0 ** (np.floor(np.log2(a)) - 7) / a


def summary_spread(ref: np.ndarray, other: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Per leaf, how far the update summaries `other` ([L, 3]: sum, sum of
    squares, max|.|) are from `ref`, by chip_smoke.py's hold_updates'
    measures relative to the leaf's max|ref|: the error of max|.|, of the
    sum of squares (over twice it) and of the sum (over sqrt(n * sum of
    squares)); the largest of the three."""
    r_sum, r_sq, r_max = ref.T
    o_sum, o_sq, o_max = other.T
    return np.max([np.abs(o_max - r_max) / r_max, np.abs(o_sq - r_sq) / (2 * r_sq),
                   np.abs(o_sum - r_sum) / np.sqrt(sizes * r_sq)], axis=0)


def bf16_bounds(metrics, f32_metrics, summary, f32_summary, keys, sizes):
    """The bounds a bf16 step is held to JAX's bf16 step by, derived from
    the size of bf16's effect in JAX itself: its bf16 step against its f32
    step on the same inputs. Two bf16 implementations each round
    differently from the f32 result, so their distance can reach twice that
    effect. Per metric, relative: the larger of twice the metric's effect
    and one bf16 ulp of its value (every metric is a sum of bf16 terms, and
    the last rounding alone can part two implementations by an ulp). Per
    leaf of the step-2 update, relative to its max|update| by
    summary_spread: twice the largest effect on any leaf of the same player
    (G: generator and condition nets; D: discriminator), and at least
    UPDATE_FLOOR. The effect on one leaf is one draw of rounding noise (on
    the icosphere model of tests/test_torch_train_prod.py, another
    implementation's distance from JAX is 0.04-5x it, leaf by leaf), so a
    player's leaves share its largest. Returns (metric bounds [STEPS, M],
    update bounds [L])."""
    effect = np.abs(metrics - f32_metrics) / np.abs(f32_metrics)
    metric_bound = np.maximum(2 * effect, bf16_ulp_rel(metrics))
    spread = summary_spread(f32_summary, summary, np.asarray(sizes))
    is_d = np.array([k.startswith("discriminator.") for k in keys])
    update_bound = np.where(is_d, spread[is_d].max(initial=0), spread[~is_d].max(initial=0))
    return metric_bound, np.maximum(2 * update_bound, UPDATE_FLOOR)


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


def train_steps(params, jcfg, ctx, batch_size: int = B, dtypes: dict | None = None):
    """Two GAN train steps of JAX (the synthetic batches of the train
    golden's recipe, eps of train_eps) from `params`. Returns the metrics
    [STEPS, len(METRICS)], eps, the step-2 updates by dotted key path and
    the steps per epoch; fills `dtypes`, if given, with each metric's
    dtype name."""
    import jax
    import jax.numpy as jnp

    from cape_tpu.data.loader import BatchStream
    from cape_tpu.data.synthetic import synthetic_bodydata
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu.train.optim import TrainState, build_optimizer, create_train_state
    from cape_tpu.train.step import _gan_losses
    from cape_tpu_torch.core.bridge import _flatten

    class EpsCAPE(JaxCAPE):
        """The reparameterization noise comes in through the rng argument."""

        def sample_z(self, rng, z_mean, z_logvar):
            # the noise in z_mean's dtype, as JAX's own sample_z draws it
            return z_mean + jnp.exp(0.5 * jnp.clip(z_logvar, -30.0, 30.0)) * rng.astype(
                z_mean.dtype)

    data = synthetic_bodydata(n_train=N_TRAIN, n_test=N_TEST, num_verts=6890, seed=jcfg.seed)
    steps_per_epoch = len(data.disp_train) // batch_size
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

    eps = train_eps(jcfg, batch_size)
    metrics = np.zeros((STEPS, len(METRICS)))
    n = len(data.disp_train)
    sg, sd = BatchStream(n, batch_size, jcfg.seed), BatchStream(n, batch_size, jcfg.seed + 1)
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
        if dtypes is not None:
            dtypes.update({k: str(m[k].dtype) for k in METRICS})
        print(f"step {i + 1}: " + " ".join(f"{k}={v:.6g}" for k, v in zip(METRICS, metrics[i])))
    assert np.isfinite(metrics).all()
    return metrics, eps, _flatten(jax.device_get(updates)), steps_per_epoch


def train_record(keys, metrics, eps, deltas, steps_per_epoch, seed, whole_max) -> dict:
    """The arrays a train golden keeps (see the module docstring)."""
    assert sorted(deltas) == keys
    whole = {f"update/{k}": deltas[k] for k in keys if deltas[k].size < whole_max}
    return dict(
        metric_names=np.array(METRICS), metrics=metrics, eps=eps, seed=seed, n_train=N_TRAIN,
        n_test=N_TEST, steps_per_epoch=steps_per_epoch,
        update_summary=np.stack([update_summary(deltas[k]) for k in keys]), **whole,
    )


def make_train(model, params):
    from cape_tpu.apps.main import build_context as jax_build_context
    from cape_tpu.core.config import load_config as jax_load_config

    keys, sums = fingerprint(model.state_dict())
    jcfg = jax_load_config(PRESET, use_pallas=False, batch_size=B)
    record = train_record(keys, *train_steps(params, jcfg, jax_build_context(jcfg)),
                          seed=jcfg.seed, whole_max=WHOLE_MAX)
    np.savez_compressed(OUT_TRAIN, param_keys=np.array(keys), param_sums=sums, **record)
    n_whole = sum(k.startswith("update/") for k in record)
    print(f"wrote {OUT_TRAIN}: {n_whole} of {len(keys)} leaves whole, "
          f"{os.path.getsize(OUT_TRAIN)} bytes")


def natural_decode() -> dict:
    """The flagship's seed-0 decode of the serve golden's inputs in the ELL
    and dense modes (natural vertex order), held to each other; the first
    KEEP_NATURAL meshes of the ELL decode."""
    import jax
    import torch

    from cape_tpu.apps.inference import InferenceEngine as JaxEngine
    from cape_tpu.apps.main import build_context as jax_build_context
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE

    cfg = load_config(PRESET, op_mode="ell")
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), build_context(cfg))
    params = jax.tree_util.tree_map(jax.numpy.asarray, to_jax_params(model))
    keys, sums = fingerprint(model.state_dict())
    z, pose, clo = golden_inputs(cfg)
    disp = {}
    for mode in ("ell", "dense"):
        jcfg = jax_load_config(PRESET, op_mode=mode, batch_size=B)
        engine = JaxEngine(JaxCAPE(jcfg), jax_build_context(jcfg), params, batch_size=B)
        y, y2 = engine.encode_only_condition(pose, clo)
        disp[mode] = engine.decode(np.concatenate([z, y, y2], -1), y, y2)
    scale = np.abs(disp["ell"]).max()
    assert np.isfinite(disp["ell"]).all()
    assert np.abs(disp["ell"] - disp["dense"]).max() <= 1e-5 * scale
    print(f"natural: disp[:{KEEP_NATURAL}] max|ref| {scale:.6g}, dense vs ell "
          f"{np.abs(disp['ell'] - disp['dense']).max() / scale:.3g} of it")
    return {"natural:disp": disp["ell"][:KEEP_NATURAL].astype(np.float32),
            "natural:param_keys": np.array(keys), "natural:param_sums": sums}


def make_families():
    """The CMR release preset and default_config.yaml: decode, encode and two
    train steps each (see the module docstring)."""
    import jax
    import torch

    from cape_tpu.apps.inference import InferenceEngine as JaxEngine
    from cape_tpu.apps.main import build_context as jax_build_context
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE

    out = {}
    for prefix, (path, overrides) in FAMILIES.items():
        cfg = load_config(path, batch_size=B, **overrides)
        model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), build_context(cfg))
        params = jax.tree_util.tree_map(jax.numpy.asarray, to_jax_params(model))
        keys, sums = fingerprint(model.state_dict())
        jcfg = jax_load_config(path, use_pallas=False, batch_size=B, **overrides)
        ctx = jax_build_context(jcfg)
        engine = JaxEngine(JaxCAPE(jcfg), ctx, params, batch_size=B)
        z, pose, clo = golden_inputs(cfg)
        y, y2 = engine.encode_only_condition(pose, clo)
        disp = engine.decode(np.concatenate([z, y, y2], -1), y, y2)
        x = encode_inputs()
        z_mean, z_logvar, _, _ = engine.encode(x, pose, clo)
        assert disp.shape == (B, 6890, 3) and np.isfinite(disp).all()
        assert np.isfinite(z_mean).all() and np.isfinite(z_logvar).all()
        train = train_steps(params, jcfg, ctx)
        rng = np.random.default_rng(3)
        nudged = jax.tree_util.tree_map(
            lambda a: jax.numpy.asarray(
                np.asarray(a) * (1 + 2.0**-24 * rng.standard_normal(a.shape))).astype(np.float32),
            params)
        deltas = train[2]
        nudged_deltas = train_steps(nudged, jcfg, ctx)[2]
        spread = update_spread(deltas, nudged_deltas, FAMILIES_WHOLE_MAX)
        record = dict(
            z=z, pose=pose, clo=clo, disp=disp[:KEEP].astype(np.float32),
            x_sums=np.array([x.astype(np.float64).sum(), np.abs(x.astype(np.float64)).sum()]),
            z_mean=np.asarray(z_mean, np.float32), z_logvar=np.asarray(z_logvar, np.float32),
            param_keys=np.array(keys), param_sums=sums,
            update_spread=spread,
            **train_record(keys, *train, seed=jcfg.seed, whole_max=FAMILIES_WHOLE_MAX),
        )
        out.update({f"{prefix}:{k}": v for k, v in record.items()})
        print(f"{prefix}: disp[:{KEEP}] max|ref| {np.abs(disp[:KEEP]).max():.6g}, "
              f"z_mean max|ref| {np.abs(z_mean).max():.6g}, update_spread {spread:.6g}")
    out.update(natural_decode())
    np.savez_compressed(OUT_FAMILIES, **out)
    print(f"wrote {OUT_FAMILIES}: {os.path.getsize(OUT_FAMILIES)} bytes")


def make_bf16():
    """bf16 compute (and bf16 optimizer state) on the flagship, two steps
    each, beside JAX's f32 steps on the same inputs (see the module
    docstring)."""
    import jax
    import torch

    from cape_tpu.apps.main import build_context as jax_build_context
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE

    cfg = load_config(PRESET)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), build_context(cfg))
    params = jax.tree_util.tree_map(jax.numpy.asarray, to_jax_params(model))
    keys, sums = fingerprint(model.state_dict())
    sizes = np.array([model.state_dict()[k].numel() for k in keys])
    out = dict(param_keys=np.array(keys), param_sums=sums, leaf_sizes=sizes,
               metric_names=np.array(METRICS))
    ctxs, f32_runs = {}, {}

    def run(batch_size, dtype, overrides):
        jcfg = jax_load_config(PRESET, use_pallas=False, batch_size=batch_size,
                               compute_dtype=dtype, **overrides)
        if dtype not in ctxs:
            ctxs[dtype] = jax_build_context(jcfg)
        dtypes = {}
        metrics, eps, deltas, spe = train_steps(params, jcfg, ctxs[dtype], batch_size, dtypes)
        summary = np.stack([update_summary(deltas[k]) for k in keys])
        return dict(metrics=metrics, eps=eps, summary=summary, spe=spe, seed=jcfg.seed,
                    dtypes=np.array([dtypes[k] for k in METRICS]))

    for prefix, (batch_size, overrides) in BF16_RUNS.items():
        print(f"{prefix}: batch {batch_size}, bfloat16 {overrides}", flush=True)
        bf = run(batch_size, "bfloat16", overrides)
        if batch_size not in f32_runs:
            print(f"{prefix}: batch {batch_size}, float32", flush=True)
            f32_runs[batch_size] = run(batch_size, "float32", {})
        f32 = f32_runs[batch_size]
        metric_bound, update_bound = bf16_bounds(bf["metrics"], f32["metrics"], bf["summary"],
                                                 f32["summary"], keys, sizes)
        record = dict(
            batch=batch_size, seed=bf["seed"], n_train=N_TRAIN, n_test=N_TEST,
            steps_per_epoch=bf["spe"], eps=bf["eps"], opt_state_dtype=overrides.get(
                "opt_state_dtype", "float32"),
            metrics=bf["metrics"], metric_dtypes=bf["dtypes"], update_summary=bf["summary"],
            f32_metrics=f32["metrics"], f32_update_summary=f32["summary"],
            metric_bound=metric_bound, update_bound=update_bound,
        )
        out.update({f"{prefix}:{k}": v for k, v in record.items()})
        print(f"{prefix}: metric dtypes {dict(zip(METRICS, bf['dtypes']))}; metric bounds "
              f"{np.round(metric_bound.max(0), 5).tolist()}; update bounds G "
              f"{update_bound[0]:.4g}, D {update_bound[keys.index('discriminator.pred.w')]:.4g}",
              flush=True)
    np.savez_compressed(OUT_BF16, **out)
    print(f"wrote {OUT_BF16}: {os.path.getsize(OUT_BF16)} bytes")


def demo_conditions(cfg):
    """The server draw's condition: the first demo pose, the first
    clothing type."""
    from cape_tpu_torch.meshops import assets
    from cape_tpu_torch.smpl.joints import filter_cloth_pose

    pose = filter_cloth_pose(assets.demo_pose_params()["rot"])[:1].astype(np.float32)
    return pose, np.eye(cfg.cond2_dim, dtype=np.float32)[:1]


def make_demo():
    import tempfile

    import torch

    from cape_tpu.apps.demos import DemoSuite
    from cape_tpu.apps.inference import InferenceEngine as JaxEngine
    from cape_tpu.apps.main import build_context as jax_build_context
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu.data.synthetic import synthetic_bodydata
    from cape_tpu.meshops.obj_io import load_obj
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu.models.gmm import GMM
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE

    import jax

    cfg = load_config(PRESET_NZ18, batch_size=B)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), build_context(cfg))
    params = jax.tree_util.tree_map(jax.numpy.asarray, to_jax_params(model))
    keys, sums = fingerprint(model.state_dict())
    jcfg = jax_load_config(PRESET_NZ18, use_pallas=False, batch_size=B)
    engine = JaxEngine(JaxCAPE(jcfg), jax_build_context(jcfg), params, batch_size=B)
    data = synthetic_bodydata(n_train=DEMO_TRAIN, n_test=DEMO_TEST, num_verts=6890,
                              seed=jcfg.seed)
    with tempfile.TemporaryDirectory() as tmp:
        suite = lambda: DemoSuite(engine, jcfg.name, jcfg.dataset, jcfg.gender, 5, True,
                                  "/nonexistent", tmp, jcfg.seed)
        s = suite()
        result = s.test_model(data)
        obj_dir = os.path.join(s.results_dir, f"test_reconstruction_objs_{jcfg.dataset}")
        recon = np.stack([load_obj(os.path.join(obj_dir, f"recon_{i:04d}.obj"))[0]
                          for i in range(DEMO_KEEP)]).astype(np.float32)
        gmm_full = suite().sample_gmm_prior(n=GMM_N)
    gmm = GMM.load_pretrained()
    key = int(np.random.default_rng(jcfg.seed).integers(1 << 30))  # a fresh suite's first key
    gmm_z = np.asarray(gmm.sample(jax.random.PRNGKey(key), GMM_N))
    srv_z = gmm.sample_np(np.random.default_rng(GMM_SEED), SERVE_N)
    pose, clo = demo_conditions(jcfg)
    y, y2 = engine.encode_only_condition(pose, clo)
    srv_disp = engine.decode(np.concatenate([srv_z, np.repeat(y, SERVE_N, 0),
                                             np.repeat(y2, SERVE_N, 0)], -1), y, y2)
    errors = np.array([result[k] for k in ("euclidean_mean_m", "euclidean_std_m",
                                           "euclidean_median_m")])
    assert np.isfinite(errors).all() and np.isfinite(srv_disp).all() and result["n_test"] == 64
    np.savez_compressed(
        OUT_DEMO, error_names=np.array(["euclidean_mean_m", "euclidean_std_m",
                                        "euclidean_median_m"]), errors=errors,
        n_train=DEMO_TRAIN, n_test=DEMO_TEST, seed=jcfg.seed, recon=recon,
        gmm_key=key, gmm_z=gmm_z.astype(np.float32), gmm_full=gmm_full[:GMM_N].astype(np.float32),
        srv_seed=GMM_SEED, srv_z=srv_z, srv_pose=pose, srv_clo=clo,
        srv_disp=srv_disp[:DEMO_KEEP].astype(np.float32),
        param_keys=np.array(keys), param_sums=sums,
    )
    print(f"wrote {OUT_DEMO}: errors {errors}, {os.path.getsize(OUT_DEMO)} bytes")


def main(argv=None):
    which = set(sys.argv[1:] if argv is None else argv) or {"serve", "train", "demo", "families",
                                                             "bf16"}
    sys.path.insert(0, ROOT)
    import jax
    import torch

    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    if "demo" in which:
        make_demo()
    if "families" in which:
        make_families()
    if "bf16" in which:
        make_bf16()
    if not which & {"serve", "train"}:
        return
    cfg = load_config(PRESET)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), build_context(cfg))
    params = jax.tree_util.tree_map(jax.numpy.asarray, to_jax_params(model))
    if "serve" in which:
        make_serve(model, params)
    if "train" in which:
        make_train(model, params)


if __name__ == "__main__":
    main()
