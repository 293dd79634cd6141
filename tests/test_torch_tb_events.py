"""The port's TensorBoard event files against the JAX package's writer and
reader (cape_tpu.train.tb_events), on the CPU: the CRC32C vectors, the same
records once parsed for the same scalars and histograms, each package
reading the other's files, and the parameter histograms of a state dict
under the tags JAX gives a param tree."""

import numpy as np
import pytest
import torch

from cape_tpu.train import tb_events as jtb
from cape_tpu_torch.core.bridge import to_jax_params
from cape_tpu_torch.train import tb_events as tb

torch.set_num_threads(1)


def test_crc32c_known_vectors():
    """RFC 3720 (iSCSI) CRC32C vectors, and the TFRecord mask."""
    assert tb.crc32c(b"") == 0x00000000
    assert tb.crc32c(b"123456789") == 0xE3069283
    assert tb.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert tb.crc32c(b"\xff" * 32) == 0x62A8AB43
    c = tb.crc32c(b"123456789")
    assert tb.masked_crc(b"123456789") == (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _strip(events):
    """The parsed events without their wall times."""
    return [{k: v for k, v in e.items() if k != "wall_time"} for e in events]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(_strip(a), _strip(b)):
        assert x.keys() == y.keys() and x["step"] == y["step"]
        assert x.get("file_version") == y.get("file_version")
        assert x["scalars"] == y["scalars"]
        assert x["histograms"].keys() == y["histograms"].keys()
        for tag, h in x["histograms"].items():
            assert h.keys() == y["histograms"][tag].keys()
            for k, v in h.items():
                np.testing.assert_array_equal(v, y["histograms"][tag][k], err_msg=f"{tag} {k}")


def _write(mod, logdir, state_tree):
    w = mod.TBEventWriter(str(logdir))
    w.add_scalars(3, {mod.tb_tag(k): v for k, v in
                      {"loss_g": 2.5, "val_recon": 0.125, "loss_d_ema": 0.75}.items()})
    w.add_scalar("train/lr_g", 8e-3, 4)
    w.add_histogram("custom/h", np.random.default_rng(1).standard_normal(1000), 4)
    w.add_histogram("custom/nan", np.array([1.0, np.nan]), 4)  # skipped by both
    w.add_param_histograms(5, state_tree)
    w.close()
    return w.path


@pytest.mark.parametrize("key", ["loss_g", "val_recon", "loss_g_ema", "lr_g"])
def test_tb_tag_equals_jax(key):
    assert tb.tb_tag(key) == jtb.tb_tag(key)


def test_records_equal_jax_and_each_reads_the_others(tmp_path, small_mesh):
    """The same scalars, histograms and parameter histograms through both
    writers: equal records once parsed (tags, steps, values, bucket limits
    and counts; wall times aside), and each package's reader parses the
    other's file to the same records. add_param_histograms takes the
    port's state dict where JAX takes the param tree, with the same tags
    (params/generator/decoder/fc1/kernel, ...) in the same order."""
    from cape_tpu_torch.core.config import CAPEConfig
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.sparse import build_graph_context
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge

    verts, faces = small_mesh
    cfg = CAPEConfig(name="tb", num_conv_layers=4, nf=8, nz=8, nz_cond=8, nz_cond2=4,
                     reduce_dim=4)
    ctx = build_graph_context(build_pyramid(verts, faces, cfg.ds_factors),
                              build_pyramid(verts, faces, [2, 2, 2, 2]),
                              vertices_per_edge(faces, len(verts)), verts, padded=True)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    ours = _write(tb, tmp_path / "ours", model.state_dict())
    ref = _write(jtb, tmp_path / "jax", to_jax_params(model))
    want = jtb.read_events(ref)
    _assert_same(tb.read_events(ours), want)
    _assert_same(jtb.read_events(ours), want)
    _assert_same(tb.read_events(ref), want)
    tags = [t for e in want if e["step"] == 5 for t in e["histograms"]]
    assert tags == ["params/" + k.replace(".", "/") for k in sorted(model.state_dict())]
    assert "params/generator/decoder/fc1/kernel" in tags
    assert want[1]["scalars"] == {"train/loss_g": 2.5, "validation/recon": 0.125,
                                  "averages/loss_d": 0.75}
