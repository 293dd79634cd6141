"""The reference against the program at toy size on the CPU: a train
cell's first three steps (both decoder families) and the served
generation."""

import numpy as np
import pytest
import torch

from bench_port import program, train_cell, weights
from bench_port.reference import model as ref
from bench_port.reference.mesh import RefMesh
from bench_port.tests import toy

torch.set_num_threads(2)


@pytest.mark.parametrize("family", ["affine", "cmr"])
def test_first_steps_match_the_reference(family):
    cf = toy.with_settings(toy.config("affine_nz64" if family == "affine" else "cmr_nz18",
                                      toy.TOY_AFFINE if family == "affine" else toy.TOY_CMR))
    mix = toy.TRAIN_MIX
    cfg = train_cell.program_config(cf, mix, toy.SEED, "toy")
    mesh, raw_of = train_cell.meshes(cf, cfg)
    _, t, (sg, sd) = train_cell.setup_program(cf, mix, toy.SEED, "toy", "cpu", mesh)
    prog = train_cell.first_steps(t, sg, sd)
    refr = train_cell.reference_steps(cf, mix, toy.SEED, "cpu", raw_of())
    gaps = train_cell.gaps(prog, refr)
    assert all(v <= mix["limits"][k] / 10 for k, v in gaps.items()), gaps
    # the three steps move the parameters: the change is compared, not zero
    assert max(refr["delta"].values()) > 0


def test_generation_matches_the_reference():
    """The engine's padded decode of [z | y | y2], un-permuted to the
    natural order, against the reference's sample_mesh."""
    cf = toy.with_settings(toy.config())
    s = cf["settings"]
    cfg = program.config(s, name="toy", seed=toy.SEED, batch_size=4, **cf["overrides"])
    mesh = program.toy_mesh(3, cfg)
    ctx = program.context(cfg, "cpu", mesh)
    perm0, perm_last = program.level_perms(cfg, mesh)
    spec = ref.param_spec(s, list(ctx.level_sizes), list(ctx.level_sizes_d))
    w = weights.make(spec, toy.SEED, "cpu")
    engine = program.engine(cfg, program.model(
        cfg, weights.port_layout(w, torch.as_tensor(perm0), torch.as_tensor(perm_last))), ctx, "cpu")
    rng = np.random.default_rng(0)
    z = rng.standard_normal((6, s["nz"])).astype(np.float32)
    pose = rng.standard_normal((1, 126)).astype(np.float32)
    clo = np.eye(4, dtype=np.float32)[[2]]
    y, y2 = engine.encode_only_condition(pose, clo)
    got = engine.decode(np.concatenate([z, np.repeat(y, 6, 0), np.repeat(y2, 6, 0)], -1), y, y2)
    want = ref.sample_mesh(s, w, RefMesh(mesh["raw"], "cpu"), torch.as_tensor(z),
                           torch.as_tensor(pose).expand(6, -1), torch.as_tensor(clo).expand(6, -1),
                           torch.float32)
    gap = np.abs(got - want.numpy()).max() / np.abs(want.numpy()).max()
    assert gap < 1e-5, gap
