"""Offline dataset packer: raw CAPE release -> packed training arrays.

Counterpart of `cape_tpu.data.packer` (numpy only; the JAX package's
packer needs jax through its Rodrigues module, which this package does not
have). It walks the npz-per-frame tree (sequences/<subj>/<cloth>_<seq>/*.npz),
computes the canonical-pose clothing displacement v_cano - minimal_cano
per frame, the per-joint rotation matrices (closed-form Rodrigues,
`smpl.rodrigues.pose_to_rotmats`) and the one-hot clothing label, and
writes {phase}_{disp,pose,rot,clo_label}.npy plus stats.txt and
broken_frames.txt under data/datasets/<name>/{train,test}/: byte-equal to
the JAX package's packer and in the reference's layout, so that packed
datasets interchange between the three.

Usage:
  python -m cape_tpu_torch.data.packer <cape_ds_dir> --gender male \
      --ds_name dataset_male_4clotypes --out data/datasets
"""

from __future__ import annotations

import os
from glob import glob
from os.path import exists, join

import numpy as np

from cape_tpu_torch.data.dataset_configs import dataset_config_dicts
from cape_tpu_torch.smpl.rodrigues import pose_to_rotmats


def pack_sequence(
    collections: dict,
    cape_ds_dir: str,
    subj: str,
    seq: str,
    cloth: str,
    cut_first: int = 2,
    sample_rate: int = 1,
) -> int | None:
    """Append one (subject, clothing, sequence) to the pack. Returns the
    number of frames added, or None if the sequence directory is empty
    (the reference distinguishes the two: an empty directory is skipped
    entirely, while a non-empty one counts toward the per-clotype
    sequence stats even when every frame is broken)."""
    data_dir = join(cape_ds_dir, "sequences", subj, f"{cloth}_{seq}")
    minimal_fn = join(
        cape_ds_dir, "minimal_body_shape", subj, f"{subj}_minimal.npy"
    )
    flist = sorted(glob(join(data_dir, "*.npz")))
    if not flist:
        return None
    minimal_cano = np.load(minimal_fn)
    flist = flist[cut_first:-cut_first:sample_rate]

    clo_onehot = (np.asarray(ALL_CLOTH_TYPES_CANONICAL) == cloth).astype(int)
    added = 0
    for fname in flist:
        try:
            frame = np.load(fname)
            pose = frame["pose"]
            vdisp = frame["v_cano"] - minimal_cano
        except Exception:
            collections["broken"].append(fname)
            continue
        # float64 on purpose: the reference computes rotations with
        # cv2.Rodrigues, which always emits float64 (lib/prep_data.py:77)
        # — packed datasets interchange byte-for-byte, and the loader
        # casts to f32 at load time either way. disp/pose pass the raw
        # frame dtype through unchanged, exactly like the reference.
        rot = pose_to_rotmats(pose.astype(np.float64)[None])[0]
        collections["disp"].append(vdisp)
        collections["pose"].append(pose)
        collections["rot"].append(rot)
        collections["clo"].append(clo_onehot)
        added += 1

    start = len(collections["disp"]) - added + 1
    collections["info"].append(
        f"{start} - {len(collections['disp'])}: {subj} {seq} {cloth}, {added} frames\n"
    )
    return added


# reference one-hot ordering (lib/prep_data.py:50): shortlong, shortshort,
# longshort, longlong — note it differs from the split-config list order.
ALL_CLOTH_TYPES_CANONICAL = ["shortlong", "shortshort", "longshort", "longlong"]


def create_dataset(
    phase: str,
    split_config: dict,
    cape_ds_dir: str,
    dataset_name: str,
    out_root: str,
) -> int:
    collections = {"disp": [], "pose": [], "rot": [], "clo": [], "info": [], "broken": []}
    # per-clotype SEQUENCE counter (not frames), substring-matched against
    # the cloth name and bumped for every non-empty sequence attempted —
    # reference lib/prep_data.py:121,138-140; feeds the first stats line
    seq_counter = {c: 0 for c in ALL_CLOTH_TYPES_CANONICAL}
    for subj in split_config[f"{phase}_subjs"]:
        for seq in split_config[f"{phase}_seqs"]:
            for cloth in split_config[f"{phase}_cloth"]:
                if seq in split_config["exclude_seqs"]:
                    continue
                if [subj, cloth] in split_config["exclude_cases"]:
                    continue
                if not exists(join(cape_ds_dir, "sequences", subj, f"{cloth}_{seq}")):
                    continue
                n = pack_sequence(
                    collections, cape_ds_dir, subj, seq, cloth,
                    cut_first=split_config["cut_first"],
                    sample_rate=split_config["sample_rate"],
                )
                if n is not None:
                    for clotype in seq_counter:
                        seq_counter[clotype] += int(clotype in cloth)
                if n:
                    print(f"packed {subj} {seq} {cloth}: {n} frames", flush=True)

    n_total = len(collections["disp"])
    if n_total == 0:
        print("no sequences found — check cape_ds_dir and the split config")
        return 0

    out_dir = join(out_root, dataset_name, phase)
    os.makedirs(out_dir, exist_ok=True)
    np.save(join(out_dir, f"{phase}_disp.npy"), np.stack(collections["disp"]))
    np.save(join(out_dir, f"{phase}_pose.npy"), np.stack(collections["pose"]))
    np.save(join(out_dir, f"{phase}_rot.npy"), np.stack(collections["rot"]))
    np.save(join(out_dir, f"{phase}_clo_label.npy"), np.stack(collections["clo"]))

    # stats.txt / broken_frames.txt are byte-identical to the reference's
    # (lib/prep_data.py:150-165) and to the JAX package's packer's
    # (tests/test_torch_packer.py diffs the bytes over the same raw tree)
    clo = np.stack(collections["clo"])
    counts = clo.sum(axis=0)
    mode = "w+" if phase == "train" else "a+"
    with open(join(out_root, dataset_name, "stats.txt"), mode) as f:
        f.write(f"-----------{phase.upper()} SET-----------\n")
        f.writelines(collections["info"])
        f.write(f"\nTotal sequences: {seq_counter} \n")
        f.write(
            "Total: {} shortlong, {} shortshort, {} longshort, {} longlong\n".format(
                *counts
            )
        )
        f.write(f"Total: {n_total} {phase} examples\n\n")
    with open(join(out_root, dataset_name, "broken_frames.txt"), mode) as f:
        f.write(f"-----------{phase.upper()} SET-----------\n")
        f.write("Broken frames that are not packed:\n")
        f.writelines(f"{b}\n" for b in collections["broken"])
    return n_total


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Pack the raw CAPE dataset")
    p.add_argument("cape_ds_dir")
    p.add_argument("--gender", choices=["male", "female"], default="male")
    p.add_argument("--ds_name", default=None)
    p.add_argument("--phase", choices=["train", "test", "both"], default="both")
    p.add_argument("--out", default=join("data", "datasets"))
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)

    ds_name = args.ds_name or f"dataset_{args.gender}_4clotypes"
    if args.overwrite:
        import shutil

        shutil.rmtree(join(args.out, ds_name), ignore_errors=True)
    split = dataset_config_dicts[args.gender]
    for phase in (["train", "test"] if args.phase == "both" else [args.phase]):
        create_dataset(phase, split, args.cape_ds_dir, ds_name, args.out)


if __name__ == "__main__":
    main()
