"""Artifact-landing drill: the full real-data pipeline, end to end.

Counterpart of `cape_tpu.tools.artifact_drill`, on the port. The
reference's production journeys are pack -> train -> evaluate and
published-checkpoint -> convert -> demo; their final validation is gated
on licensed artifacts (the CAPE dataset, published TF checkpoints). This
drill proves every stage hands off to the next, running the same commands
with synthetic stand-ins wherever an artifact is missing, so that on the
day the artifacts land the same invocation with real paths is all that is
needed:

  python -m cape_tpu_torch.tools.artifact_drill --workdir build/drill \\
      [--raw <cape_release_dir>]   # else: fabricates a tiny raw tree
      [--tf_ckpt <ckpt path>]      # else: fabricates reference-named vars
      [--epochs N] [--threshold_mm X] [--device cpu]

Stages (each prints one `DRILL <stage> ok` line; the first failure
raises):
  pack    raw release tree -> packed dataset (data.packer.create_dataset)
  train   packed dataset -> Trainer.fit -> checkpoints under workdir
  accept  tools.acceptance against the packed test split + checkpoint
  convert TF variables -> params .npz (tools.tf_ckpt_converter; through a
          real TF Saver file when TensorFlow is importable, else in memory)
  demo    simple demo CLI from the converted .npz (apps.simple_demo)
  deploy  trained checkpoint -> int8/bf16 artifact (tools.export_model) ->
          model server on ExportedEngine -> client /sample round trip

With no --raw/--tf_ckpt this is a smoke of the glue (the acceptance metric
is then judged against a pass-anything threshold; the real thresholds are
6.1 mm male / 3.7 mm female). It runs on the card; without one it raises
unless --device cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def fabricate_raw_cape(
    root: str,
    verts: np.ndarray,
    subj: str = "00032",
    seqs: tuple = ("drill_a", "drill_b"),
    cloths: tuple = ("longlong", "shortlong"),
    n_frames: int = 10,
    seed: int = 0,
) -> None:
    """A minimal raw-release tree in the packer's expected layout
    (sequences/<subj>/<cloth>_<seq>/*.npz + minimal_body_shape), with
    frames on the real template so the SMPL pyramid applies."""
    rng = np.random.default_rng(seed)
    minimal = np.asarray(verts, np.float64)
    os.makedirs(os.path.join(root, "minimal_body_shape", subj), exist_ok=True)
    np.save(os.path.join(root, "minimal_body_shape", subj, f"{subj}_minimal.npy"), minimal)
    for seq in seqs:
        for cloth in cloths:
            d = os.path.join(root, "sequences", subj, f"{cloth}_{seq}")
            os.makedirs(d, exist_ok=True)
            for i in range(n_frames):
                np.savez(
                    os.path.join(d, f"frame_{i:04d}.npz"),
                    pose=0.3 * rng.standard_normal(72),
                    v_cano=minimal + 0.005 * rng.standard_normal(minimal.shape),
                )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="CAPE artifact-landing drill")
    p.add_argument("--workdir", required=True)
    p.add_argument("--raw", default=None, help="real CAPE release dir (else fabricate)")
    p.add_argument("--tf_ckpt", default=None, help="published TF checkpoint (else fabricate)")
    p.add_argument("--config", default="configs/CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
    p.add_argument("--gender", default="male")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--threshold_mm", type=float, default=None,
                   help="acceptance gate; default: pass-anything in drill "
                        "mode, the real per-gender threshold with --raw")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from cape_tpu_torch.apps.main import build_context, require_device
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.data.dataset_configs import dataset_config_dicts
    from cape_tpu_torch.data.loader import BodyData
    from cape_tpu_torch.data.packer import create_dataset
    from cape_tpu_torch.meshops import assets
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.train.loop import Trainer

    require_device(args.device)
    dev = ["--device", args.device]
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    datadir_root = os.path.join(workdir, "datasets")
    drill_mode = args.raw is None
    name = "drill_run"

    cfg = load_config(
        args.config, name=name, gender=args.gender,
        num_epochs=args.epochs, batch_size=args.batch_size,
    )

    # ------------------------------------------------------------- 1. pack
    raw = args.raw
    split = dict(dataset_config_dicts[args.gender])
    if drill_mode:
        raw = os.path.join(workdir, "raw_standin")
        verts, _ = assets.template_mesh()
        fabricate_raw_cape(raw, verts)
        split.update(
            train_subjs=["00032"], test_subjs=["00032"],
            train_seqs=["drill_a"], test_seqs=["drill_b"],
            train_cloth=["longlong", "shortlong"],
            test_cloth=["longlong", "shortlong"],
        )
    n_train = create_dataset("train", split, raw, cfg.dataset, datadir_root)
    n_test = create_dataset("test", split, raw, cfg.dataset, datadir_root)
    assert n_train > 0 and n_test > 0, (n_train, n_test)
    print(f"DRILL pack ok: {n_train} train / {n_test} test frames", flush=True)

    # ------------------------------------------------------------ 2. train
    data = BodyData.from_packed(
        os.path.join(datadir_root, cfg.dataset), pose_type=cfg.pose_type,
        n_val=100 if not drill_mode else 4,
    )
    ctx = build_context(cfg, device=args.device)
    # PRNGKey(cfg.seed): the parameters JAX's Trainer.fit starts from
    model = CAPE(cfg).init_params(prng.PRNGKey(cfg.seed), ctx).to(args.device)
    trainer = Trainer(cfg, model, ctx, data, workdir=workdir)
    val_losses, _ = trainer.fit()
    assert np.all(np.isfinite(val_losses)), val_losses
    print(f"DRILL train ok: val recon {val_losses[-1]:.4f}", flush=True)

    # ----------------------------------------------------------- 3. accept
    from cape_tpu_torch.tools import acceptance

    accept_args = [
        "--config", args.config, "--name", name,
        "--datadir_root", datadir_root, "--workdir", workdir,
        "--gender", args.gender,   # threshold selection must match training
    ] + dev
    if args.threshold_mm is not None:
        accept_args += ["--threshold_mm", str(args.threshold_mm)]
    elif drill_mode:
        accept_args += ["--threshold_mm", "1e9"]  # plumbing smoke only
    try:
        acceptance.main(accept_args)
    except SystemExit as e:
        assert e.code == 0, f"acceptance gate failed (exit {e.code})"
    print("DRILL accept ok", flush=True)

    # ---------------------------------------------------------- 4. convert
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.tools.tf_ckpt_converter import (
        _permute_flat_vertex_axis, convert, flatten_tree, read_tf_checkpoint,
        synthesize_reference_vars, verify_against_template,
    )

    # perm handling mirrors tf_ckpt_converter.main: only the banded runtime
    # stores per-vertex params in RCM/coarse order; ell-mode configs stay
    # natural and must not be permuted
    perm = ctx.perm0
    coarse_perm = None
    if cfg.op_mode == "banded":
        from cape_tpu_torch.meshops.ordering import pyramid_orderings
        from cape_tpu_torch.meshops.pyramid import load_or_build

        coarse_perm = pyramid_orderings(load_or_build(cfg.ds_factors))[-1]

    if args.tf_ckpt is not None:
        tfvars = read_tf_checkpoint(args.tf_ckpt)
    else:
        ref_params = to_jax_params(CAPE(cfg).init_params(prng.PRNGKey(7), ctx))
        tfvars = synthesize_reference_vars(ref_params, cfg)
        if perm is not None:
            # real checkpoints store every vertex-indexed quantity in
            # natural order: un-permute the out bias and the flattened
            # coarse-vertex axes of the fc heads so the fabricated
            # checkpoint is what the published archive would hold
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            inv_c = np.empty_like(coarse_perm)
            inv_c[coarse_perm] = np.arange(len(coarse_perm))
            tfvars["generator/decoder/outputs/bias"] = np.asarray(
                ref_params["generator"]["decoder"]["out"]["b"]
            )[inv][None]
            for head in ("fc_mean", "fc_var"):
                k = f"generator/encoder/{head}/dense/kernel"
                tfvars[k] = _permute_flat_vertex_axis(tfvars[k], inv_c, axis=0)
            tfvars["generator/decoder/fc1/dense/kernel"] = _permute_flat_vertex_axis(
                tfvars["generator/decoder/fc1/dense/kernel"], inv_c, axis=1
            )
            tfvars["generator/decoder/fc1/dense/bias"] = _permute_flat_vertex_axis(
                tfvars["generator/decoder/fc1/dense/bias"], inv_c, axis=0
            )
        # write and read back a real tf.train.Saver file when TF is
        # importable (the journey of checkpoint-landing day); else stay
        # in memory
        try:
            from cape_tpu_torch.tools.tf_ckpt_converter import write_tf_checkpoint

            saved = write_tf_checkpoint(
                tfvars, os.path.join(workdir, "tf_standin", "model"),
                global_step=100, fake_slots=True,
            )
            tfvars = read_tf_checkpoint(saved)
            print(f"DRILL convert: via real TF Saver file {saved}", flush=True)
        except ImportError:
            print("DRILL convert: TF unavailable, in-memory variables", flush=True)
    converted = convert(tfvars, cfg, vertex_perm=perm, coarse_perm=coarse_perm)
    verify_against_template(converted, model, ctx)
    npz_path = os.path.join(workdir, "converted_params.npz")
    np.savez(npz_path, **flatten_tree(converted))
    print(f"DRILL convert ok: {npz_path}", flush=True)

    # ------------------------------------------------------------- 5. demo
    from cape_tpu_torch.apps import simple_demo

    demo_dir = os.path.join(workdir, "demo_results")
    simple_demo.main(
        ["--config", args.config, "--params", npz_path, "--results_dir", demo_dir] + dev
    )
    objs = []
    for _, _, files in os.walk(demo_dir):
        objs += [f for f in files if f.endswith(".obj")]
    assert objs, f"demo produced no meshes under {demo_dir}"
    print(f"DRILL demo ok: {len(objs)} meshes", flush=True)

    # ----------------------------------------------------------- 6. deploy
    # trained checkpoint -> compressed single-file artifact -> served over
    # HTTP -> client round trip: the deployment handoff, end to end
    import threading

    from cape_tpu_torch.apps.client import CapeClient
    from cape_tpu_torch.apps.server import serve
    from cape_tpu_torch.tools import export_model as export_cli
    from cape_tpu_torch.tools.export_model import ExportedEngine, ExportedModel

    capex = os.path.join(workdir, f"{name}.capex")
    # the operator invocation, like the accept and demo stages (the CLI
    # owns the restore and the plain-route pin)
    export_cli.main([
        "--out", capex, "--workdir", workdir,
        "--quantize", "int8", "--constants-dtype", "bfloat16",
        "--config", args.config, "--name", name, "--gender", args.gender,
        "--batch_size", str(args.batch_size),
        "--num_epochs", str(args.epochs),  # cfg must re-derive identically
    ] + dev)
    engine = ExportedEngine(ExportedModel.load(capex, device=args.device))
    httpd, ms = serve(engine, "127.0.0.1", 0)
    ms.warmup()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        client = CapeClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        disp, _ = client.sample(
            np.zeros((1, cfg.cond_dim), np.float32),
            np.eye(cfg.cond2_dim, dtype=np.float32)[:1], n=2, seed=0,
        )
        assert disp.shape == (2, int(engine.ctx.level_sizes[0]), 3), disp.shape
        assert np.isfinite(disp).all()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)
    print(
        f"DRILL deploy ok: {capex} ({os.path.getsize(capex) / 1e6:.1f} MB) "
        "served and sampled", flush=True,
    )

    print(json.dumps({
        "drill": "ok",
        "mode": "standin" if drill_mode else "real",
        "frames": {"train": n_train, "test": n_test},
        "workdir": workdir,
    }))


if __name__ == "__main__":
    main()
