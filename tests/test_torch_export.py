"""The port's AOT artifact (`cape_tpu_torch.tools.export_model`) against the
JAX package on the CPU: the flagship template at nf=8 (JAX's own export
test configuration), one module-scoped export per artifact kind (f32, a
symbolic batch, int8 weights with bf16 constants), held to the JAX live
`InferenceEngine` on the same parameters; the artifact's members, its
graph of aten operators, its load in a process that imports torch alone,
its refusals, and the sampled autoencode's host draw."""

import json
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from cape_tpu.apps.inference import InferenceEngine as JaxEngine
from cape_tpu.core.config import CAPEConfig as JaxConfig
from cape_tpu.models.cape import CAPE as JaxCAPE
from cape_tpu_torch.apps.main import build_context
from cape_tpu_torch.core.bridge import to_jax_params
from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.tools.export_model import (
    FORMAT, ExportedEngine, ExportedModel, export_model, quantize_params,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the configuration of the JAX package's tests/test_export.py
SMALL = dict(name="export_test", nf=8, nz=18, nz_cond=24, nz_cond2=8, use_res_block=False,
             use_res_block_dec=True, affine=True, reduce_dim=8, batch_size=4)
KINDS = {"f32": {}, "symbolic": {"symbolic_batch": True},
         "int8": {"quantize": "int8", "constants_dtype": "bfloat16"}}


@pytest.fixture(scope="module")
def setup(flagship_ctx, tmp_path_factory):
    """The port model from torch.Generator seed 0 and, on its parameters
    (bridged), the JAX engine at batch 4; the port's context."""
    cfg = CAPEConfig(**SMALL)
    ctx = build_context(cfg)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    params = to_jax_params(model)
    jeng = JaxEngine(JaxCAPE(JaxConfig(**SMALL)), flagship_ctx, params, batch_size=4)
    return cfg, model, ctx, params, jeng, tmp_path_factory.mktemp("export")


@pytest.fixture(scope="module")
def artifacts(setup):
    """kind -> (path, meta, ExportedModel loaded on the CPU), each
    exported and loaded once, at its first use."""
    cfg, model, ctx, params, _, root = setup
    made = {}

    def get(kind):
        if kind not in made:
            path = str(root / f"{kind}.capex")
            meta = export_model(model, ctx, params, 4, path, **KINDS[kind])
            made[kind] = path, meta, ExportedModel.load(path, device="cpu")
        return made[kind]

    return get


def _inputs(n, seed, cfg):
    rng = np.random.default_rng(seed)
    disp = (0.01 * rng.standard_normal((n, 6890, 3))).astype(np.float32)
    pose = rng.standard_normal((n, cfg.cond_dim)).astype(np.float32)
    clo = np.eye(cfg.cond2_dim, dtype=np.float32)[rng.integers(0, cfg.cond2_dim, n)]
    return disp, pose, clo


def _decode(em, zt, y, y2):
    """The decode program called directly, at the batch of its inputs."""
    with torch.inference_mode():
        return em._calls["decode"](*(torch.from_numpy(a) for a in (zt, y, y2))).numpy()


def _close(got, want, name=""):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_artifact_matches_the_jax_engine(setup, artifacts):
    """embed, encode, decode and the deterministic autoencode of the f32
    artifact within 1e-4 * max|ref| of the JAX live engine on the same
    parameters, 5 rows (2 padded calls at batch 4), natural vertex order."""
    cfg, *_, jeng, _ = setup
    eng = ExportedEngine(artifacts("f32")[2])
    assert eng.batch_size == 4 and eng.device == torch.device("cpu")
    disp, pose, clo = _inputs(5, 0, cfg)
    for name, g, w in zip(("y", "y2"), eng.encode_only_condition(pose, clo),
                          jeng.encode_only_condition(pose, clo)):
        _close(g, w, f"embed {name}")
    got = eng.encode(disp, pose, clo)
    for name, g, w in zip(("z_mean", "z_logvar", "y", "y2"), got, jeng.encode(disp, pose, clo)):
        _close(g, w, f"encode {name}")
    zt = np.concatenate([got[0], got[2], got[3]], -1)
    _close(eng.decode(zt, got[2][:1], got[3][:1]), jeng.decode(zt, got[2][:1], got[3][:1]),
           "decode")
    _close(eng.autoencode(disp, pose, clo), jeng.autoencode(disp, pose, clo), "autoencode")


def test_meta_and_members(setup, artifacts):
    cfg = setup[0]
    path, meta, _ = artifacts("f32")
    assert meta == {
        "format": FORMAT, "model": "export_test", "batch_size": 4, "symbolic_batch": False,
        "num_verts": 6890, "quantize": None, "constants_dtype": None, "nz": cfg.nz,
        "nz_cond": cfg.nz_cond, "nz_cond2": cfg.nz_cond2, "cond_dim": cfg.cond_dim,
        "cond2_dim": cfg.cond2_dim, "compute_dtype": "float32", "platforms": ["cpu", "cuda"],
        "contract": "z-scored displacements, natural template vertex order",
        "torch_version": torch.__version__,
    }
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["decode.pt2", "embed.pt2", "encode.pt2", "meta.json"]
        assert json.loads(zf.read("meta.json")) == meta


def test_artifact_runs_with_torch_alone(artifacts):
    """The deployment claim: decode.pt2 loads and runs in a process that
    imports torch and the standard library only; no module of either
    package is loaded."""
    path = artifacts("f32")[0]
    code = (
        "import io, json, sys, zipfile\n"
        "import torch\n"
        "with zipfile.ZipFile(sys.argv[1]) as zf:\n"
        "    fn = torch.export.load(io.BytesIO(zf.read('decode.pt2'))).module()\n"
        "out = fn(torch.zeros(4, 50), torch.zeros(4, 24), torch.zeros(4, 8))\n"
        "print(json.dumps([list(out.shape), bool(torch.isfinite(out).all()),\n"
        "                  sorted(m for m in sys.modules if m.startswith('cape_tpu'))]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, path], capture_output=True, text=True,
                         timeout=120, check=True, cwd=os.path.dirname(path))
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[4, 6890, 3], True, []]


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_programs_hold_only_aten_operators(artifacts, kind):
    for name, ep in artifacts(kind)[2].programs.items():
        targets = {n.target for n in ep.graph.nodes if n.op == "call_function"}
        assert targets, name
        bad = [t for t in targets
               if not (isinstance(t, torch._ops.OpOverload) and t.namespace == "aten")]
        assert not bad, (name, bad)


def test_symbolic_batch_runs_any_batch(setup, artifacts):
    """One symbolic-batch artifact runs at B = 1, 3 and 7 (none the export
    batch) and matches the fixed-batch artifact (4 rows a call)."""
    cfg = setup[0]
    sym = artifacts("symbolic")[2]
    assert sym.meta["symbolic_batch"] is True
    fixed = ExportedEngine(artifacts("f32")[2])
    rng = np.random.default_rng(2)
    for B in (1, 3, 7):
        zt = rng.standard_normal((B, cfg.z_total_dim)).astype(np.float32)
        y = rng.standard_normal((B, cfg.nz_cond)).astype(np.float32)
        y2 = rng.standard_normal((B, cfg.nz_cond2)).astype(np.float32)
        out = _decode(sym, zt, y, y2)
        assert out.shape == (B, 6890, 3)
        _close(out, fixed.decode(zt, y, y2), f"B={B}")


def test_int8_bf16_artifact_is_smaller_and_close(setup, artifacts):
    """int8 weights with bf16 constants: the file under 0.7x the f32 one,
    the int8 tables and bf16 constants stored as such (no folding back to
    f32), the decode within relative L2 0.05 of the f32 artifact's and of
    the JAX engine's, and quantize_params bit-equal to the JAX package's."""
    from cape_tpu.tools.export_model import quantize_params as jax_quantize

    cfg, _, _, params, jeng, _ = setup
    (p8, meta, em8), (p32, _, em32) = artifacts("int8"), artifacts("f32")
    eng8, eng32 = ExportedEngine(em8), ExportedEngine(em32)
    assert meta["quantize"] == "int8" and meta["constants_dtype"] == "bfloat16"
    assert os.path.getsize(p8) < 0.7 * os.path.getsize(p32)
    sd = em8.programs["decode"].state_dict
    assert sd["generator.decoder.fc1.kernel.int8"].dtype == torch.int8
    assert sd["generator.decoder.fc1.kernel.scale"].shape == (params["generator"]["decoder"]
                                                             ["fc1"]["kernel"].shape[-1],)
    assert sd["generator.decoder.out.b"].dtype == torch.float32
    consts = [t for t in em8.programs["decode"].constants.values() if t.is_floating_point()]
    assert consts and all(t.dtype == torch.bfloat16 for t in consts)

    rng = np.random.default_rng(4)
    zt = rng.standard_normal((4, cfg.z_total_dim)).astype(np.float32)
    y = rng.standard_normal((4, cfg.nz_cond)).astype(np.float32)
    y2 = rng.standard_normal((4, cfg.nz_cond2)).astype(np.float32)
    out8 = eng8.decode(zt, y, y2)
    assert np.isfinite(out8).all()
    for ref in (eng32.decode(zt, y, y2), jeng.decode(zt, y, y2)):
        ref = np.asarray(ref)
        assert np.linalg.norm(out8 - ref) / np.linalg.norm(ref) < 0.05

    q, jq = quantize_params(params), jax_quantize(params)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat(q)] == [
        jax.tree_util.keystr(k) for k, _ in flat(jq)]
    for (path, a), (_, b) in zip(flat(q), flat(jq)):
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    assert q["generator"]["decoder"]["fc1"]["kernel"]["int8"].dtype == np.int8


def test_refuses_non_artifacts_and_jax_artifacts(tmp_path):
    bad = tmp_path / "bad.capex"
    with zipfile.ZipFile(bad, "w") as zf:
        zf.writestr("meta.json", json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not a cape_tpu_torch export artifact"):
        ExportedModel.load(str(bad), device="cpu")
    text = tmp_path / "model.txt"
    text.write_text("not a zip")
    with pytest.raises(ValueError, match="not a cape_tpu_torch export artifact"):
        ExportedModel.load(str(text), device="cpu")
    # the JAX package's layout: its meta.json beside StableHLO programs
    jax_art = tmp_path / "jax.capex"
    with zipfile.ZipFile(jax_art, "w") as zf:
        zf.writestr("meta.json", json.dumps({"format": "cape_tpu.export/1"}))
        for name in ("embed", "encode", "decode"):
            zf.writestr(f"{name}.shlo", b"")
    with pytest.raises(ValueError, match="is a JAX artifact"):
        ExportedModel.load(str(jax_art), device="cpu")


def test_sampled_autoencode_draws_numpy_eps(setup, artifacts):
    """sample=True draws eps on the host as the JAX artifact engine does.
    Held to the JAX package's own ExportedEngine.autoencode, run over a
    stand-in of its ExportedModel whose programs are the JAX live engine's
    jitted embed, encode and decode (in natural vertex order, as an
    artifact's), at seeds below and above 2**32 and with no seed."""
    from cape_tpu.tools.export_model import ExportedEngine as JaxExportedEngine
    from cape_tpu.tools.export_model import ExportedModel as JaxExportedModel

    cfg, *_, jeng, _ = setup
    em = artifacts("f32")[2]
    eng = ExportedEngine(em)

    def encode(d, p, c):
        y, y2 = jeng._embed(jeng.params, p, c)
        zm, zl = jeng._encode(jeng.params, jeng.ctx, jeng._to_device_order(d), y, y2)
        return zm, zl, y, y2

    calls = {
        "embed": lambda p, c: jeng._embed(jeng.params, p, c),
        "encode": encode,
        "decode": lambda z, a, b: jeng._to_natural_order(
            np.asarray(jeng._decode(jeng.params, jeng.ctx, z, a, b))),
    }
    jax_art = JaxExportedEngine(JaxExportedModel(em.meta, calls))
    disp, pose, clo = _inputs(3, 5, cfg)
    for seed in (None, 7, 2**32 + 7):
        _close(eng.autoencode(disp, pose, clo, rng=seed, sample=True),
               jax_art.autoencode(disp, pose, clo, rng=seed, sample=True), f"seed {seed}")
    np.testing.assert_array_equal(eng.autoencode(disp, pose, clo, sample=True),
                                  eng.autoencode(disp, pose, clo, rng=0, sample=True))
    assert not np.allclose(eng.autoencode(disp, pose, clo, rng=1, sample=True),
                           eng.autoencode(disp, pose, clo, rng=2, sample=True))


def test_load_needs_a_gpu_unless_asked_for_the_cpu(artifacts, monkeypatch):
    """The default device is the card: with no GPU, load raises naming
    device='cpu' before it reads the file; device='cpu' loads (as every
    test here does)."""
    path, _, em = artifacts("f32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExportedModel.load(path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ExportedModel.load(path, device="cuda")
    assert em.device == torch.device("cpu")
