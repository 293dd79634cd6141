"""The port's dataset packer against the JAX package's, on the CPU: the split
configurations, and every packed file byte-equal on a synthetic raw CAPE
tree (npz per frame, a torn frame, an empty sequence directory), through
create_dataset and through `python -m cape_tpu_torch.data.packer`, which
loads no JAX; and the train entry's notice that names it."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _raw_tree(root: str, subjects, seqs, cloths, n_frames=8, nv=27, seed=7) -> None:
    """minimal_body_shape/<subj>/<subj>_minimal.npy and
    sequences/<subj>/<cloth>_<seq>/frame_*.npz, with one torn frame inside
    the kept [2:-2] slice and one empty sequence directory."""
    rng = np.random.default_rng(seed)
    for subj in subjects:
        minimal = rng.standard_normal((nv, 3))
        os.makedirs(os.path.join(root, "minimal_body_shape", subj))
        np.save(os.path.join(root, "minimal_body_shape", subj, f"{subj}_minimal.npy"), minimal)
        for seq in seqs:
            for cloth in cloths:
                d = os.path.join(root, "sequences", subj, f"{cloth}_{seq}")
                os.makedirs(d)
                for i in range(n_frames):
                    np.savez(os.path.join(d, f"frame_{i:04d}.npz"),
                             pose=0.4 * rng.standard_normal(72),
                             v_cano=minimal + 0.02 * rng.standard_normal((nv, 3)))
    torn = os.path.join(root, "sequences", subjects[0], f"{cloths[0]}_{seqs[0]}",
                        "frame_0002.npz")
    with open(torn, "wb") as fh:
        fh.write(b"not a zip archive")
    os.makedirs(os.path.join(root, "sequences", subjects[0], f"{cloths[-1]}_stretch"))


def _files(root: str) -> dict[str, bytes]:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_dataset_configs_equal_jax():
    from cape_tpu.data import dataset_configs as jax_configs
    from cape_tpu_torch.data import dataset_configs

    assert dataset_configs.dataset_config_dicts == jax_configs.dataset_config_dicts
    assert dataset_configs.ALL_CLOTH_TYPES == jax_configs.ALL_CLOTH_TYPES


def test_create_dataset_is_byte_equal_to_jax(tmp_path):
    """Both phases (stats.txt appended by the test phase), a sample rate of
    2, an excluded (subject, clothing) case: every .npy, stats.txt and
    broken_frames.txt byte-equal to the JAX packer's, the torn frame logged."""
    from cape_tpu.data.packer import create_dataset as jax_create
    from cape_tpu_torch.data.packer import create_dataset

    raw = str(tmp_path / "raw")
    subjects, seqs, cloths = ("00032", "00096"), ("move_arms", "squat"), ("longlong", "shortshort")
    _raw_tree(raw, subjects, seqs, cloths)
    split = {
        "train_subjs": list(subjects), "train_seqs": list(seqs) + ["stretch"],
        "train_cloth": list(cloths), "test_subjs": [subjects[1]], "test_seqs": [seqs[0]],
        "test_cloth": list(cloths), "exclude_seqs": [],
        "exclude_cases": [["00096", "shortshort"]], "cut_first": 2, "sample_rate": 2,
    }
    counts = {}
    for name, fn in (("ours", create_dataset), ("jax", jax_create)):
        counts[name] = [fn(phase, split, raw, "ds", str(tmp_path / name))
                        for phase in ("train", "test")]
    assert counts["ours"] == counts["jax"] and min(counts["ours"]) > 0
    ours, ref = _files(str(tmp_path / "ours")), _files(str(tmp_path / "jax"))
    assert sorted(ours) == sorted(ref)
    assert {"ds/train/train_rot.npy", "ds/test/test_disp.npy", "ds/stats.txt",
            "ds/broken_frames.txt"} <= set(ours)
    for k in ref:
        assert ours[k] == ref[k], k
    assert b"frame_0002.npz" in ours["ds/broken_frames.txt"]


def test_packer_cli_loads_no_jax_and_matches_jax(tmp_path):
    """`python -m cape_tpu_torch.data.packer <raw> --gender male` on a tree
    of the male split's subjects and sequences writes the JAX packer's
    bytes (its main() on the same tree), with no jax, flax, optax, yaml or
    cape_tpu module loaded in its process."""
    from cape_tpu.data.packer import main as jax_main

    raw = str(tmp_path / "raw")
    _raw_tree(raw, ("00032", "00127"), ("ATUsquat", "soccer"), ("longlong", "shortlong"))
    code = (
        "import sys, runpy\n"
        "sys.argv = ['packer'] + sys.argv[1:]\n"
        "runpy.run_module('cape_tpu_torch.data.packer', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax', 'yaml', 'cape_tpu')\n"
        "             or m.startswith('cape_tpu.'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code, raw, "--gender", "male", "--out",
                    str(tmp_path / "ours")], check=True, cwd=ROOT, timeout=300)
    jax_main([raw, "--gender", "male", "--out", str(tmp_path / "jax")])
    ours, ref = _files(str(tmp_path / "ours")), _files(str(tmp_path / "jax"))
    assert "dataset_male_4clotypes/test/test_clo_label.npy" in ours
    assert ours == ref


def test_train_entry_names_the_ports_packer(tmp_path, capsys):
    """With no packed dataset, load_bodydata falls back to the synthetic set
    with a notice that names the port's own packer (not the JAX package's,
    which needs JAX)."""
    from cape_tpu_torch.apps.main import load_bodydata
    from cape_tpu_torch.core.config import CAPEConfig

    data = load_bodydata(CAPEConfig(name="x"), datadir_root=str(tmp_path))
    out = capsys.readouterr().out
    assert len(data.disp_train) > 0
    assert "WARNING: packed dataset" in out
    assert "pack the CAPE release with `python -m cape_tpu_torch.data.packer`" in out
    assert "cape_tpu.data.packer" not in out
