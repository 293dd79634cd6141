"""TF-checkpoint -> cape_tpu_torch params converter.

Counterpart of `cape_tpu.tools.tf_ckpt_converter`. The reference publishes
pretrained TF1 checkpoints (tf.train.Saver format, lib/models.py:351).
This tool maps every reference variable to the parameter tree in the JAX
package's layout, whose key paths are the port's module paths
(`core.bridge`), so a published model loads into the port with
`load_state_dict`:

  reference scope/variable                      -> parameter path
  condition_pose/fc1/dense/{kernel,bias}        -> cond_pose.fc1.{kernel,bias}
  condition_clo_label/fc1/dense/{kernel,bias}   -> cond_clo.fc1.{kernel,bias}
  generator/encoder/encoder_conv{i}/weights     -> generator.encoder.layer{i-1}.w
  generator/encoder/encoder_conv{i}/bias        -> generator.encoder.layer{i-1}.b
  generator/encoder/encoder_resblock{i}/...     -> generator.encoder.layer{i-1}.{conv1,conv2,proj}
  generator/encoder/1x1-conv/weights            -> generator.encoder.reduce.w
  generator/encoder/fc_mean/dense/...           -> generator.encoder.fc_mean....
  generator/decoder/fc1/dense/...               -> generator.decoder.fc1....
  generator/decoder/1x1-conv/weights            -> generator.decoder.expand.w
  generator/decoder/decoder_conv{i}/...         -> generator.decoder.layer{i-1}....
  generator/decoder/decoder_resblock_affine{i}/ -> generator.decoder.layer{i-1}.{conv,affine}
  generator/decoder/decoder_resblock_cmr{i}/    -> generator.decoder.layer{i-1}.{gn0,lin1,...}
  generator/decoder/outputs/{weights,bias}      -> generator.decoder.out.{w,b}
  discriminator/shared/conv{i}/{weights,bias}   -> discriminator.layer{i-1}.{w,b}
  discriminator/prediction_map/weights          -> discriminator.pred.w

Chebyshev filterbanks are relaid out from the reference's flat
[Fin*K, Fout] (row index fin*K + k, lib/models.py:97-101) to [K, Fin,
Fout]. Per-filter biases [1,1,F] squeeze to [F]; the per-vertex output
bias [1,V,F] squeezes to [V,F].

The mapping is numpy. Only `read_tf_checkpoint` and `write_tf_checkpoint`
need TensorFlow, which they import when called (without it they raise
ImportError).

Usage:
  python -m cape_tpu_torch.tools.tf_ckpt_converter <ckpt_prefix_or_dir> \
      --config configs/CAPE-affineconv_nz64_pose32_clotype32_male.yaml \
      --out converted_params.npz [--verify]
"""

from __future__ import annotations

import os
import re

import numpy as np


def read_tf_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Read all variables from a TF checkpoint prefix (or a directory
    containing one) into {name: array}. Optimizer slot variables
    (Momentum/Adam) are dropped."""
    from tensorflow.python.training import py_checkpoint_reader

    if os.path.isdir(path):
        import tensorflow as tf

        latest = tf.train.latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = latest
    reader = py_checkpoint_reader.NewCheckpointReader(path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if re.search(r"/(Momentum|Adam|Adam_1)$", name):
            continue
        if name in ("training/global_step", "global_step"):
            continue
        if "ExponentialMovingAverage" in name or name.startswith("loss/"):
            continue
        out[name] = reader.get_tensor(name)
    return out


def write_tf_checkpoint(
    tfvars: dict[str, np.ndarray],
    prefix: str,
    global_step: int | None = None,
    fake_slots: bool = False,
) -> str:
    """Save reference-named variables as a REAL tf.train.Saver (V2 format)
    checkpoint — the exact on-disk format of the published models
    (reference lib/models.py:351 `tf.train.Saver(max_to_keep=5)`).

    Used by the artifact drill so the read_tf_checkpoint -> convert journey
    exercises genuine TF-written files, not in-memory dicts. fake_slots additionally writes an optimizer
    slot variable and a global_step, which read_tf_checkpoint must filter.
    Returns the saved checkpoint prefix (what latest_checkpoint resolves).
    """
    import tensorflow as tf

    g = tf.Graph()
    with g.as_default():
        for name, v in tfvars.items():
            tf.compat.v1.Variable(np.asarray(v), name=name)
        if fake_slots:
            first = next(iter(tfvars))
            tf.compat.v1.Variable(
                np.zeros_like(np.asarray(tfvars[first])), name=f"{first}/Momentum"
            )
            tf.compat.v1.Variable(
                np.int64(global_step or 0), name="training/global_step"
            )
        saver = tf.compat.v1.train.Saver(max_to_keep=5)
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            return saver.save(sess, prefix, global_step=global_step)


def cheb_to_ours(w_flat: np.ndarray, K: int) -> np.ndarray:
    """[Fin*K, Fout] (row = fin*K + k) -> [K, Fin, Fout]."""
    fin = w_flat.shape[0] // K
    return np.ascontiguousarray(
        w_flat.reshape(fin, K, w_flat.shape[1]).transpose(1, 0, 2)
    )


def ours_to_tf_cheb(w: np.ndarray) -> np.ndarray:
    """[K, Fin, Fout] -> reference flat [Fin*K, Fout] (row = fin*K + k)."""
    K, fin, fout = np.asarray(w).shape
    return np.ascontiguousarray(np.asarray(w).transpose(1, 0, 2).reshape(fin * K, fout))


def synthesize_reference_vars(params: dict, cfg) -> dict:
    """Inverse of convert() for every block family: our param tree -> a
    reference-named TF variable dict (lib/models.py scope names).

    Used by the artifact-landing drill (tools.artifact_drill) to exercise
    the published-checkpoint journey without the license-gated checkpoint
    archive."""
    tf = {}
    tf["condition_pose/fc1/dense/kernel"] = params["cond_pose"]["fc1"]["kernel"]
    tf["condition_pose/fc1/dense/bias"] = params["cond_pose"]["fc1"]["bias"]
    tf["condition_pose/fc2/dense/kernel"] = params["cond_pose"]["fc2"]["kernel"]
    tf["condition_pose/fc2/dense/bias"] = params["cond_pose"]["fc2"]["bias"]
    tf["condition_clo_label/fc1/dense/kernel"] = params["cond_clo"]["fc1"]["kernel"]
    tf["condition_clo_label/fc1/dense/bias"] = params["cond_clo"]["fc1"]["bias"]
    if "fc2" in params["cond_clo"]:
        tf["condition_clo_label/fc2/dense/kernel"] = params["cond_clo"]["fc2"]["kernel"]
        tf["condition_clo_label/fc2/dense/bias"] = params["cond_clo"]["fc2"]["bias"]

    enc = params["generator"]["encoder"]
    for i in range(cfg.num_conv_layers):
        layer = enc[f"layer{i}"]
        if cfg.use_res_block:
            s = f"generator/encoder/encoder_resblock{i + 1}"
            tf[f"{s}/filter_1/weights"] = ours_to_tf_cheb(np.asarray(layer["conv1"]["w"]))
            tf[f"{s}/bias_relu_1/bias"] = np.asarray(layer["conv1"]["b"]).reshape(1, 1, -1)
            tf[f"{s}/filter_2/weights"] = ours_to_tf_cheb(np.asarray(layer["conv2"]["w"]))
            tf[f"{s}/bias_relu_2/bias"] = np.asarray(layer["conv2"]["b"]).reshape(1, 1, -1)
            if "proj" in layer:
                tf[f"{s}/1x1-conv/weights"] = ours_to_tf_cheb(np.asarray(layer["proj"]["w"]))
        else:
            s = f"generator/encoder/encoder_conv{i + 1}"
            tf[f"{s}/weights"] = ours_to_tf_cheb(np.asarray(layer["w"]))
            tf[f"{s}/bias"] = np.asarray(layer["b"]).reshape(1, 1, -1)
    if "reduce" in enc:
        tf["generator/encoder/1x1-conv/weights"] = ours_to_tf_cheb(np.asarray(enc["reduce"]["w"]))
    for head in ("fc_mean", "fc_var"):
        tf[f"generator/encoder/{head}/dense/kernel"] = enc[head]["kernel"]
        tf[f"generator/encoder/{head}/dense/bias"] = enc[head]["bias"]

    dec = params["generator"]["decoder"]
    tf["generator/decoder/fc1/dense/kernel"] = dec["fc1"]["kernel"]
    tf["generator/decoder/fc1/dense/bias"] = dec["fc1"]["bias"]
    if "expand" in dec:
        tf["generator/decoder/1x1-conv/weights"] = ours_to_tf_cheb(np.asarray(dec["expand"]["w"]))
    for i in range(cfg.num_conv_layers):
        layer = dec[f"layer{i}"]
        if cfg.use_res_block_dec and cfg.affine:
            s = f"generator/decoder/decoder_resblock_affine{i + 1}"
            tf[f"{s}/graph_conv/weights"] = ours_to_tf_cheb(np.asarray(layer["conv"]["w"]))
            tf[f"{s}/affine/weights"] = ours_to_tf_cheb(np.asarray(layer["affine"]["w"]))
        elif cfg.use_res_block_dec:
            s = f"generator/decoder/decoder_resblock_cmr{i + 1}"
            tf[f"{s}/group_norm/gamma"] = np.asarray(layer["gn0"]["gamma"])
            tf[f"{s}/group_norm/beta"] = np.asarray(layer["gn0"]["beta"])
            tf[f"{s}/graph_linear_1/weights"] = ours_to_tf_cheb(np.asarray(layer["lin1"]["w"]))
            tf[f"{s}/group_norm_1/gamma"] = np.asarray(layer["gn1"]["gamma"])
            tf[f"{s}/group_norm_1/beta"] = np.asarray(layer["gn1"]["beta"])
            tf[f"{s}/graph_conv/weights"] = ours_to_tf_cheb(np.asarray(layer["conv"]["w"]))
            tf[f"{s}/group_norm_2/gamma"] = np.asarray(layer["gn2"]["gamma"])
            tf[f"{s}/group_norm_2/beta"] = np.asarray(layer["gn2"]["beta"])
            tf[f"{s}/graph_linear_2/weights"] = ours_to_tf_cheb(np.asarray(layer["lin2"]["w"]))
            if "proj" in layer:
                tf[f"{s}/graph_linear_input/weights"] = ours_to_tf_cheb(np.asarray(layer["proj"]["w"]))
        else:
            s = f"generator/decoder/decoder_conv{i + 1}"
            tf[f"{s}/weights"] = ours_to_tf_cheb(np.asarray(layer["w"]))
            tf[f"{s}/bias"] = np.asarray(layer["b"]).reshape(1, 1, -1)
    tf["generator/decoder/outputs/weights"] = ours_to_tf_cheb(np.asarray(dec["out"]["w"]))
    tf["generator/decoder/outputs/bias"] = np.asarray(dec["out"]["b"])[None]

    disc = params["discriminator"]
    i = 0
    while f"layer{i}" in disc:
        s = f"discriminator/shared/conv{i + 1}"
        tf[f"{s}/weights"] = ours_to_tf_cheb(np.asarray(disc[f"layer{i}"]["w"]))
        tf[f"{s}/bias"] = np.asarray(disc[f"layer{i}"]["b"]).reshape(1, 1, -1)
        i += 1
    tf["discriminator/prediction_map/weights"] = ours_to_tf_cheb(np.asarray(disc["pred"]["w"]))
    return {k: np.asarray(v) for k, v in tf.items()}


def _conv(tfvars, scope: str, K: int) -> dict:
    p = {"w": cheb_to_ours(tfvars[f"{scope}/weights"], K)}
    if f"{scope}/bias" in tfvars:
        p["b"] = tfvars[f"{scope}/bias"].reshape(-1)
    return p


def _dense(tfvars, scope: str) -> dict:
    return {
        "kernel": tfvars[f"{scope}/dense/kernel"],
        "bias": tfvars[f"{scope}/dense/bias"],
    }


def _gn(tfvars, scope: str) -> dict:
    return {"gamma": tfvars[f"{scope}/gamma"], "beta": tfvars[f"{scope}/beta"]}


def _permute_flat_vertex_axis(k: np.ndarray, perm: np.ndarray, axis: int) -> np.ndarray:
    """Permute the vertex factor of a flattened [V*C] dense axis.

    The encoder flatten / decoder reshape use row-major [B, V, C] ->
    [B, V*C] (lib/models.py:554, 584), so flat index = v*C + c; the banded
    runtime's coarse level lives in permuted vertex order, so kernel
    rows/columns must follow."""
    k = np.asarray(k)
    V = len(perm)
    C = k.shape[axis] // V
    shape = list(k.shape)
    shape[axis : axis + 1] = [V, C]
    kr = k.reshape(shape)
    kr = np.take(kr, np.asarray(perm), axis=axis)
    return np.ascontiguousarray(kr.reshape(k.shape))


def convert(
    tfvars: dict[str, np.ndarray],
    cfg,
    vertex_perm: np.ndarray | None = None,
    coarse_perm: np.ndarray | None = None,
) -> dict:
    """Build the parameter tree (the JAX package's layout) from reference
    TF variables for the architecture described by cfg (a CAPEConfig).

    vertex_perm: level-0 vertex permutation of the target runtime (the
    banded op mode stores the per-vertex decoder output bias in device
    order); None for natural-order (ell/dense) runtimes.
    coarse_perm: coarsest-level vertex permutation (pyramid_orderings[-1]).
    The encoder fc_mean/fc_var kernels and the decoder fc1 kernel+bias
    index flattened coarse-level vertices (lib/models.py:554-560, 579-584),
    which the banded runtime holds in permuted order — without this their
    vertex factor stays natural and a converted checkpoint produces garbage
    latents.
    """
    K, Kd, n = cfg.K, cfg.Kd, cfg.num_conv_layers

    cond_pose = {
        "fc1": _dense(tfvars, "condition_pose/fc1"),
        "fc2": _dense(tfvars, "condition_pose/fc2"),
    }
    cond_clo = {"fc1": _dense(tfvars, "condition_clo_label/fc1")}
    if "condition_clo_label/fc2/dense/kernel" in tfvars:
        cond_clo["fc2"] = _dense(tfvars, "condition_clo_label/fc2")

    encoder: dict = {}
    for i in range(n):
        if cfg.use_res_block:
            scope = f"generator/encoder/encoder_resblock{i + 1}"
            layer = {
                "conv1": {
                    "w": cheb_to_ours(tfvars[f"{scope}/filter_1/weights"], K),
                    "b": tfvars[f"{scope}/bias_relu_1/bias"].reshape(-1),
                },
                "conv2": {
                    "w": cheb_to_ours(tfvars[f"{scope}/filter_2/weights"], K),
                    "b": tfvars[f"{scope}/bias_relu_2/bias"].reshape(-1),
                },
            }
            if f"{scope}/1x1-conv/weights" in tfvars:
                layer["proj"] = {"w": cheb_to_ours(tfvars[f"{scope}/1x1-conv/weights"], 1)}
            encoder[f"layer{i}"] = layer
        else:
            encoder[f"layer{i}"] = _conv(tfvars, f"generator/encoder/encoder_conv{i + 1}", K)
    if cfg.reduce_dim > 0:
        encoder["reduce"] = {
            "w": cheb_to_ours(tfvars["generator/encoder/1x1-conv/weights"], 1)
        }
    encoder["fc_mean"] = _dense(tfvars, "generator/encoder/fc_mean")
    encoder["fc_var"] = _dense(tfvars, "generator/encoder/fc_var")
    if coarse_perm is not None:
        for head in ("fc_mean", "fc_var"):
            encoder[head]["kernel"] = _permute_flat_vertex_axis(
                encoder[head]["kernel"], coarse_perm, axis=0
            )

    decoder: dict = {"fc1": _dense(tfvars, "generator/decoder/fc1")}
    if coarse_perm is not None:
        decoder["fc1"]["kernel"] = _permute_flat_vertex_axis(
            decoder["fc1"]["kernel"], coarse_perm, axis=1
        )
        decoder["fc1"]["bias"] = _permute_flat_vertex_axis(
            decoder["fc1"]["bias"], coarse_perm, axis=0
        )
    if cfg.reduce_dim > 0:
        decoder["expand"] = {
            "w": cheb_to_ours(tfvars["generator/decoder/1x1-conv/weights"], 1)
        }
    for i in range(n):
        if cfg.use_res_block_dec and cfg.affine:
            scope = f"generator/decoder/decoder_resblock_affine{i + 1}"
            decoder[f"layer{i}"] = {
                "conv": {"w": cheb_to_ours(tfvars[f"{scope}/graph_conv/weights"], K)},
                "affine": {"w": cheb_to_ours(tfvars[f"{scope}/affine/weights"], 1)},
            }
        elif cfg.use_res_block_dec:
            scope = f"generator/decoder/decoder_resblock_cmr{i + 1}"
            layer = {
                "gn0": _gn(tfvars, f"{scope}/group_norm"),
                "lin1": {"w": cheb_to_ours(tfvars[f"{scope}/graph_linear_1/weights"], 1)},
                "gn1": _gn(tfvars, f"{scope}/group_norm_1"),
                "conv": {"w": cheb_to_ours(tfvars[f"{scope}/graph_conv/weights"], K)},
                "gn2": _gn(tfvars, f"{scope}/group_norm_2"),
                "lin2": {"w": cheb_to_ours(tfvars[f"{scope}/graph_linear_2/weights"], 1)},
            }
            if f"{scope}/graph_linear_input/weights" in tfvars:
                layer["proj"] = {
                    "w": cheb_to_ours(tfvars[f"{scope}/graph_linear_input/weights"], 1)
                }
            decoder[f"layer{i}"] = layer
        else:
            decoder[f"layer{i}"] = _conv(tfvars, f"generator/decoder/decoder_conv{i + 1}", K)
    out_bias = tfvars["generator/decoder/outputs/bias"]
    out_bias = out_bias.reshape(out_bias.shape[-2:])
    if vertex_perm is not None:
        out_bias = out_bias[np.asarray(vertex_perm)]
    decoder["out"] = {
        "w": cheb_to_ours(tfvars["generator/decoder/outputs/weights"], K),
        "b": out_bias,
    }

    disc: dict = {}
    i = 0
    while f"discriminator/shared/conv{i + 1}/weights" in tfvars:
        disc[f"layer{i}"] = _conv(tfvars, f"discriminator/shared/conv{i + 1}", Kd)
        i += 1
    disc["pred"] = {
        "w": cheb_to_ours(tfvars["discriminator/prediction_map/weights"], K)
    }

    return {
        "cond_pose": cond_pose,
        "cond_clo": cond_clo,
        "generator": {"encoder": encoder, "decoder": decoder},
        "discriminator": disc,
    }


def flatten_tree(tree: dict) -> dict[str, np.ndarray]:
    """{keypath string: array} of a nested parameter dict, the keys the JAX
    package's `flatten_tree` writes (`['generator']['decoder']['fc1']
    ['kernel']`), which `core.bridge.load_jax_checkpoint` reads."""
    from cape_tpu_torch.core.bridge import jax_keypath

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({jax_keypath(k) + p: a for p, a in flatten_tree(v).items()})
        else:
            out[jax_keypath(k)] = np.asarray(v)
    return out


def verify_against_template(params: dict, model, ctx) -> None:
    """Shape-check the converted tree against the port model's state dict
    (`model`'s own parameters, or a fresh init on `ctx` when it has none),
    key for key through `core.bridge.jax_keypath`."""
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.core.bridge import jax_keypath
    from cape_tpu_torch.models.cape import CAPE

    if next(model.parameters(), None) is None:
        model = CAPE(model.cfg).init_params(prng.PRNGKey(0), ctx)  # JAX's template
    converted = flatten_tree(params)
    for path, t in model.state_dict().items():
        key = jax_keypath(path)
        if key not in converted:
            raise KeyError(f"converted params missing {key}")
        if tuple(converted[key].shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch at {key}: converted {converted[key].shape} "
                f"vs model {tuple(t.shape)}"
            )


def main(argv=None):
    import argparse

    from cape_tpu_torch.core.config import load_config

    p = argparse.ArgumentParser(description="Convert a reference TF checkpoint")
    p.add_argument("checkpoint", help="TF checkpoint prefix or directory")
    p.add_argument("--config", required=True, help="matching YAML config preset")
    p.add_argument("--out", default="converted_params.npz")
    p.add_argument("--verify", action="store_true", help="shape-check vs a fresh init")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    tfvars = read_tf_checkpoint(args.checkpoint)

    vertex_perm = coarse_perm = None
    if cfg.op_mode == "banded":
        # the banded runtime stores per-vertex params in RCM order; the
        # pyramid must match the one build_context uses for this config
        from cape_tpu_torch.meshops.ordering import pyramid_orderings
        from cape_tpu_torch.meshops.pyramid import load_or_build

        perms = pyramid_orderings(load_or_build(cfg.ds_factors))
        vertex_perm, coarse_perm = perms[0], perms[-1]
    params = convert(tfvars, cfg, vertex_perm=vertex_perm, coarse_perm=coarse_perm)

    if args.verify:
        from cape_tpu_torch.apps.main import build_context
        from cape_tpu_torch.models.cape import CAPE

        verify_against_template(params, CAPE(cfg), build_context(cfg))

    np.savez(args.out, **flatten_tree(params))
    n = sum(v.size for v in tfvars.values())
    print(f"wrote {args.out} ({n} source values)")


if __name__ == "__main__":
    main()
