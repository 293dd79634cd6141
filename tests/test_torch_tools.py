"""The port's training tools and normal losses against the JAX package's, on
the CPU: the face and vertex normal losses, plot_metrics' dashboard,
acceptance's refusal without a packed dataset, the dtype ablation and the
optimizer-state A/B at a small width (the flagship template, nf=8), and the
endurance run at that width."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
# the flagship architecture at a small width
NARROW = dict(nf=8, nz=8, nz_cond=8, nz_cond2=4, reduce_dim=8, batch_size=2)


@pytest.mark.parametrize("with_op", [False, True])
def test_normal_losses_match_jax(small_mesh, with_op):
    """face_normal_loss, vertex_normal_loss (index_add or the [V, F]
    incidence operator) and the normals themselves against
    cape_tpu.losses / cape_tpu.meshops.normals, f32, 1e-6 relative; a
    degenerate gt face is left out of the mean in both."""
    from cape_tpu import losses as jl
    from cape_tpu.meshops import normals as jn
    from cape_tpu_torch import losses as tl
    from cape_tpu_torch.meshops import normals as tn

    verts, faces = small_mesh
    rng = np.random.default_rng(6)
    gt = (verts[None] + 0.05 * rng.standard_normal((3,) + verts.shape)).astype(np.float32)
    pred = (gt + 0.02 * rng.standard_normal(gt.shape)).astype(np.float32)
    f0 = faces[0]
    gt[:, f0[1]] = gt[:, f0[0]]  # face 0 of gt collapses to an edge
    gt[:, f0[2]] = gt[:, f0[0]]
    t, j = torch.from_numpy, jnp.asarray
    tf, jf = t(faces.astype(np.int64)), j(faces.astype(np.int32))
    if with_op:
        m = tn.vertex_normal_matrix(faces, len(verts)).toarray().astype(np.float32)
        top, jop = (lambda x: t(m) @ x), (lambda x: j(m) @ x)
    else:
        top = jop = None
    pairs = [
        (tn.face_normals(t(pred), tf), jn.face_normals(j(pred), jf)),
        (tn.vertex_normals(t(pred), tf, top), jn.vertex_normals(j(pred), jf, jop)),
        (tl.face_normal_loss(t(pred), t(gt), tf), jl.face_normal_loss(j(pred), j(gt), jf)),
        (tl.vertex_normal_loss(t(pred), t(gt), tf, top),
         jl.vertex_normal_loss(j(pred), j(gt), jf, jop)),
    ]
    for i, (got, want) in enumerate(pairs):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=str(i))
    assert float(pairs[2][0]) > 0 and not np.any(tn.face_normals(t(gt), tf)[:, 0].numpy())


def test_plot_metrics_html_equals_jax(tmp_path):
    """The port's dashboard of a metrics.jsonl (step records, an epoch record
    with EMA, val and lr keys, and a torn tail line) is byte-equal to the
    JAX package's; the CLI writes the same file."""
    from cape_tpu.tools.plot_metrics import plot_metrics as jax_plot
    from cape_tpu_torch.tools.plot_metrics import plot_metrics

    run = tmp_path / "run_x"
    run.mkdir()
    with open(run / "metrics.jsonl", "w") as fh:
        for s in range(0, 40, 10):
            fh.write(json.dumps({"step": s, "t": s * 0.1, "loss_g": 3.0 - s * 0.01,
                                 "loss_d": 0.5, "recon": 1.0 / (s + 1)}) + "\n")
        fh.write(json.dumps({"step": 39, "t": 4.0, "loss_g": 2.5, "loss_d": 0.4, "recon": 0.02,
                             "loss_g_ema": 2.7, "loss_d_ema": 0.45, "val_recon": 0.03,
                             "epoch": 1, "lr_g": 8e-3, "step_ms": 11.0}) + "\n")
        fh.write('{"step": 40, "loss_g": 2.4')
    want = open(jax_plot(str(run), str(tmp_path / "jax.html"))).read()
    got = plot_metrics(str(run))
    assert got == str(run / "metrics.html")
    assert open(got).read() == want and "stroke-dasharray" in want
    subprocess.run([sys.executable, "-m", "cape_tpu_torch.tools.plot_metrics", str(run), "-o",
                    str(tmp_path / "cli.html")], check=True, cwd=ROOT, timeout=120)
    assert open(tmp_path / "cli.html").read() == want


def test_acceptance_refuses_without_a_packed_dataset(tmp_path, monkeypatch, capsys):
    """Without data/datasets/<dataset>, the port's acceptance exits 2 with
    the JAX tool's message (and the port's packer named), before it builds
    anything, as the JAX tool does."""
    from cape_tpu.tools import acceptance as jax_acceptance
    from cape_tpu_torch.apps import main as app_main
    from cape_tpu_torch.tools import acceptance

    built = []
    monkeypatch.setattr(app_main, "build_context", lambda *a, **k: built.append(1))
    args = ["--config", FLAGSHIP, "--name", "x", "--datadir_root", str(tmp_path),
            "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        acceptance.main(args)
    err = capsys.readouterr().err
    assert exc.value.code == 2 and not built
    assert "dataset_male_4clotypes' not found" in err and "cape_tpu_torch.data.packer" in err
    with pytest.raises(SystemExit) as jexc:
        jax_acceptance.main(args[:-2])
    jerr = capsys.readouterr().err
    assert jexc.value.code == 2 and jerr.split(" — ")[0] == err.split(" — ")[0]


def test_dtype_ablation_and_opt_state_ab_run_narrow_on_the_cpu(tmp_path, monkeypatch):
    """dtype_ablation (one epoch per dtype) and opt_state_ab (one step per
    block) with the tools' configuration cut to nf=8 at batch 2 on the CPU:
    the JAX tools' JSON keys, finite values, a bf16 state half the f32
    state's bytes, and memory "not measured" (None) off the GPU; both raise
    without a GPU unless asked for the CPU."""
    from cape_tpu_torch.tools import dtype_ablation, opt_state_ab

    for k, v in NARROW.items():  # opt_state_ab reads the same dict
        monkeypatch.setitem(dtype_ablation.ABLATION, k, v)
    monkeypatch.setattr(dtype_ablation, "N_TRAIN", 12)
    monkeypatch.setattr(dtype_ablation, "N_TEST", 4)
    monkeypatch.setattr(opt_state_ab, "STEPS_PER_DISPATCH", 1)
    out = dtype_ablation.main(["--epochs", "1", "--device", "cpu", "--workdir", str(tmp_path)])
    for dtype in ("float32", "bfloat16"):
        r = out[dtype]
        assert r["dtype"] == dtype
        assert set(r) == {"dtype", "val_recon", "val_edge", "euclidean_mean",
                          "euclidean_median", "first_val_recon", "last_val_recon", "wall_s"}
        assert all(np.isfinite(v) for k, v in r.items() if k != "dtype")
    assert set(out["verdict"]) == {"rel_euclidean_gap", "rel_val_recon_gap", "bf16_within_2pct"}
    ab = opt_state_ab.main(["--dispatches", "1", "--device", "cpu", "--save",
                            str(tmp_path / "ab.json")])
    assert ab["device"] == "cpu" and ab["compute_dtype"] == "bfloat16"
    for arm in ("f32_state", "bf16_state"):
        assert len(ab[arm]["block_medians_ms"]) == 2 and ab[arm]["step_peak_mb"] is None
    assert ab["bf16_state"]["state_mb"] == pytest.approx(ab["f32_state"]["state_mb"] / 2)
    assert json.load(open(tmp_path / "ab.json"))["bf16_vs_f32"] == ab["bf16_vs_f32"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            opt_state_ab.main([])
        with pytest.raises(RuntimeError, match="--device cpu"):
            dtype_ablation.main(["--workdir", str(tmp_path)])


ENDURANCE_KEYS = {"steps", "epochs", "wall_s", "sustained_steps_per_sec",
                  "sec_per_step_incl_overheads", "final_val_recon", "val_recon_first",
                  "checkpoints_kept", "batch", "dtype", "device"}


@pytest.fixture
def narrow_flagship(monkeypatch):
    from cape_tpu_torch.tools import flagship

    for k, v in NARROW.items():
        if k != "batch_size":
            monkeypatch.setitem(flagship.FLAGSHIP, k, v)


def test_endurance_runs_the_schedule_on_the_cpu(tmp_path, narrow_flagship, monkeypatch, capsys):
    """tools.endurance on the flagship cut to nf=8, --device cpu: the
    production Trainer.fit over the synthetic split (n_val=100, so 8 train
    frames: 2 steps an epoch at batch 4), its checkpoints under
    <workdir>/endurance_torch, and the JAX tool's JSON line with finite
    val losses."""
    from cape_tpu_torch.tools import endurance
    from cape_tpu_torch.train.loop import Trainer

    fits = []
    real_fit = Trainer.fit
    monkeypatch.setattr(Trainer, "fit", lambda self: fits.append(self.num_steps) or real_fit(self))
    argv = ["--device", "cpu", "--epochs", "2", "--n-train", "108", "--batch", "4",
            "--dtype", "float32", "--workdir", str(tmp_path)]
    out = endurance.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(line) == ENDURANCE_KEYS
    assert fits == [4] and line["steps"] == 4 and line["epochs"] == 2
    assert line["device"] == "cpu" and line["batch"] == 4 and line["dtype"] == "float32"
    assert np.isfinite(line["final_val_recon"]) and np.isfinite(line["val_recon_first"])
    assert line["checkpoints_kept"] == 2
    assert sorted(os.listdir(tmp_path / "endurance_torch" / "checkpoints")) and \
        (tmp_path / "endurance_torch" / "metrics.jsonl").exists()


def test_endurance_expect_final_is_a_gate_and_needs_a_gpu(tmp_path, narrow_flagship,
                                                          monkeypatch, capsys):
    """--expect-final passes on the run's own final_val_recon (6 decimals)
    and raises on another; without a GPU and without --device cpu the run
    raises before it builds anything."""
    from cape_tpu_torch.tools import endurance, flagship
    from cape_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(Trainer, "fit", lambda self: ([0.5, 0.2500001], 0.01))
    argv = ["--device", "cpu", "--epochs", "1", "--n-train", "104", "--batch", "4",
            "--workdir", str(tmp_path)]
    assert endurance.main(argv + ["--expect-final", "0.25"])["matches_pinned_final"] == 0.25
    with pytest.raises(AssertionError, match="final_val_recon 0.25 != expected 0.3"):
        endurance.main(argv + ["--expect-final", "0.3"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(flagship, "flagship_setup", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        endurance.main(["--epochs", "1"])
