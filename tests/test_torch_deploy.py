"""The port's deployment path on the CPU: the model server on an exported
artifact (in process and through its CLI), the CLI's refusals, /viewer
for an artifact engine, the TF-checkpoint converter against the JAX
package's (bit for bit, and through a real TF Saver file), the kernel
lab's `artifact` subcommand with its timer stubbed, and the artifact drill
end to end on a narrow preset."""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cape_tpu_torch.apps.inference import InferenceEngine
from cape_tpu_torch.core.bridge import load_jax_checkpoint, to_jax_params
from cape_tpu_torch.core.config import CAPEConfig, load_config
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.tools.export_model import ExportedEngine, ExportedModel, export_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
SMALL = dict(
    name="deploy_test", nz=8, nz_cond=8, nz_cond2=4, nf=8, use_res_block=False,
    use_res_block_dec=True, affine=True, reduce_dim=8, batch_size=4,
)


@pytest.fixture(scope="module")
def icosphere(small_mesh, tmp_path_factory):
    """A 258-vertex icosphere model (torch.Generator seed 0), its live
    engine and its f32 artifact at batch 4, loaded on the CPU."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    cfg = CAPEConfig(**SMALL)
    ctx = build_graph_context(
        build_pyramid(verts, faces, cfg.ds_factors), build_pyramid(verts, faces, [2, 2, 2, 2]),
        vertices_per_edge(faces, len(verts)), verts, padded=True,
    )
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    path = str(tmp_path_factory.mktemp("deploy") / "ico.capex")
    export_model(model, ctx, to_jax_params(model), 4, path)
    return cfg, model, ctx, path, ExportedEngine(ExportedModel.load(path, device="cpu"))


def _post(base, path, body):
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _close(got, want, rel=1e-5, name=""):
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name)


def test_server_serves_an_artifact(icosphere):
    """serve(ExportedEngine): /health names the artifact's model, dims and
    device; /reconstruct equals the artifact engine's deterministic
    autoencode and is within 1e-4 * max|ref| of the live engine on the
    same parameters; /sample's z is the host draw and its meshes the
    artifact's decode of it; /viewer is a 404 (not the SMPL topology)."""
    from cape_tpu_torch.apps.server import serve

    cfg, model, ctx, _, eng = icosphere
    httpd, ms = serve(eng, "127.0.0.1", 0)
    ms.warmup()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            info = json.loads(resp.read())
        assert info == {"status": "ok", "model": "deploy_test", "num_verts": 258, "nz": 8,
                        "nz_cond": 8, "nz_cond2": 4, "cond_dim": 126, "cond2_dim": 4,
                        "batch_size": 4, "compute_dtype": "float32", "gmm_prior": False,
                        "device": "cpu"}
        rng = np.random.default_rng(3)
        disp = (0.05 * rng.standard_normal((5, 258, 3))).astype(np.float32)
        pose = rng.standard_normal((5, 126)).astype(np.float32)
        clo = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 5)]
        status, out = _post(base, "/reconstruct",
                            {"disp": disp.tolist(), "pose": pose.tolist(), "clo": clo.tolist()})
        assert status == 200
        got = np.asarray(out["disp"], np.float32)
        _close(got, eng.autoencode(disp, pose, clo), name="/reconstruct vs artifact engine")
        live = InferenceEngine(model, ctx, 4, device="cpu")
        _close(got, live.autoencode(disp, pose, clo), rel=1e-4, name="/reconstruct vs live")

        status, out = _post(base, "/sample", {"pose": pose[:1].tolist(), "clo": clo[:1].tolist(),
                                              "n": 6, "seed": 11})
        assert status == 200
        z = np.asarray(out["z"], np.float32)
        np.testing.assert_array_equal(
            z, np.random.default_rng(11).standard_normal((6, 8)).astype(np.float32))
        y, y2 = eng.encode_only_condition(pose[:1], clo[:1])
        y, y2 = np.repeat(y, 6, 0), np.repeat(y2, 6, 0)
        _close(np.asarray(out["disp"], np.float32),
               eng.decode(np.concatenate([z, y, y2], -1), y, y2), name="/sample")
        try:
            urllib.request.urlopen(base + "/viewer", timeout=30)
            raise AssertionError("/viewer answered 200")
        except urllib.error.HTTPError as e:
            assert e.code == 404 and "no mesh topology" in json.loads(e.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)


def test_viewer_artifact_engine_topology_handling():
    """GET /viewer for an artifact engine (which ships no template and no
    natural-order mapping): 258 vertices get ServerError (the transport's
    404), not an AttributeError (a 500); a 6890-vertex artifact takes its
    template from assets/ and gets the page. The port of the JAX test of
    the same name (tests/test_server.py)."""
    from types import SimpleNamespace

    from cape_tpu_torch.apps.server import ModelServer, ServerError

    def artifact_engine(nv):
        return SimpleNamespace(
            batch_size=4, device=torch.device("cpu"),
            model=SimpleNamespace(cfg=SimpleNamespace(
                name="artifact", nz=8, nz_cond=8, nz_cond2=4, cond_dim=126, cond2_dim=4,
                compute_dtype="float32", z_total_dim=20,
            )),
            ctx=SimpleNamespace(level_sizes=[nv]),
        )

    with pytest.raises(ServerError, match="no mesh topology"):
        ModelServer(artifact_engine(258), micro_batch=False).viewer_html()
    page = ModelServer(artifact_engine(6890), micro_batch=False).viewer_html()
    assert b"/sample" in page and len(page) > 10_000


@pytest.mark.parametrize("flags", [["--fresh-init"], ["--workdir", "runs"],
                                   ["--config", FLAGSHIP], ["--batch_size", "8"]],
                         ids=["fresh-init", "workdir", "config", "batch_size"])
def test_server_cli_refuses_checkpoint_flags_with_an_artifact(flags, monkeypatch, capsys):
    """A baked artifact takes none of the checkpoint mode's flags: the CLI
    exits 2 naming them, before it loads anything (JAX's CLI does the
    same)."""
    from cape_tpu_torch.apps import server
    from cape_tpu_torch.tools import export_model

    monkeypatch.setattr(export_model.ExportedModel, "load",
                        classmethod(lambda *a, **k: pytest.fail("loaded the artifact")))
    with pytest.raises(SystemExit) as e:
        server.main(["--artifact", "model.capex", "--device", "cpu"] + flags)
    assert e.value.code == 2
    assert "unsupported flags with --artifact" in capsys.readouterr().err


def test_artifact_clis_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    """With no GPU, the server's --artifact and the export CLI raise naming
    --device cpu before they load or build anything."""
    from cape_tpu_torch.apps import main as app_main
    from cape_tpu_torch.apps import server
    from cape_tpu_torch.tools import export_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(export_model.ExportedModel, "load",
                        classmethod(lambda *a, **k: pytest.fail("loaded the artifact")))
    monkeypatch.setattr(app_main, "build_context", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        server.main(["--artifact", "model.capex"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        export_model.main(["--config", FLAGSHIP, "--name", "x", "--fresh-init",
                           "--out", "m.capex"])


def test_server_cli_serves_an_artifact_and_stops_on_sigterm(icosphere):
    """`python -m cape_tpu_torch.apps.server --artifact <file> --device cpu
    --port 0` announces its port, answers /health and /sample, and exits 0
    on SIGTERM."""
    path = icosphere[3]
    cmd = [sys.executable, "-m", "cape_tpu_torch.apps.server", "--artifact", path,
           "--device", "cpu", "--port", "0"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    watchdog = threading.Timer(180, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        assert lines and lines[-1].startswith("serving deploy_test on http://"), lines
        base = lines[-1].split(" on ")[1].strip()
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            assert json.loads(resp.read())["num_verts"] == 258
        status, out = _post(base, "/sample", {"pose": [[0.0] * 126], "clo": [[1, 0, 0, 0]],
                                              "n": 2})
        assert status == 200 and np.asarray(out["disp"]).shape == (2, 258, 3)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# ---------------------------------------------------------------- converter
@pytest.fixture(scope="module")
def flagship_tree():
    """The flagship's parameter tree at full width (torch.Generator seed 1;
    numpy, no model call) and the banded runtime's level-0 and coarsest
    vertex permutations."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.meshops.ordering import pyramid_orderings
    from cape_tpu_torch.meshops.pyramid import load_or_build

    cfg = load_config(FLAGSHIP)
    ctx = build_context(cfg)
    params = to_jax_params(CAPE(cfg).init_params(torch.Generator().manual_seed(1), ctx))
    perms = pyramid_orderings(load_or_build(cfg.ds_factors))
    return cfg, ctx, params, np.asarray(perms[0]), np.asarray(perms[-1])


def _same_tree(a: dict, b: dict):
    fa, fb = (dict((jax.tree_util.keystr(k), v)
                   for k, v in jax.tree_util.tree_flatten_with_path(t)[0]) for t in (a, b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_converter_matches_jax_bit_for_bit(flagship_tree):
    """synthesize_reference_vars, _permute_flat_vertex_axis, convert (with
    both permutations) and flatten_tree give the JAX package's arrays and
    keys bit for bit on the flagship tree; verify_against_template passes
    the converted tree and names a missing or misshapen leaf."""
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu.tools import tf_ckpt_converter as jconv
    from cape_tpu.train.checkpoint import flatten_tree as jax_flatten_tree
    from cape_tpu_torch.tools import tf_ckpt_converter as conv

    cfg, ctx, params, perm, coarse = flagship_tree
    jcfg = jax_load_config(FLAGSHIP)
    tfvars, jtfvars = conv.synthesize_reference_vars(params, cfg), jconv.synthesize_reference_vars(
        params, jcfg)
    assert sorted(tfvars) == sorted(jtfvars)
    for k in tfvars:
        np.testing.assert_array_equal(tfvars[k], jtfvars[k], err_msg=k)
    k = "generator/decoder/fc1/dense/kernel"
    for axis in (0, 1):
        arr = tfvars[k] if axis == 1 else tfvars["generator/encoder/fc_mean/dense/kernel"]
        np.testing.assert_array_equal(conv._permute_flat_vertex_axis(arr, coarse, axis),
                                      jconv._permute_flat_vertex_axis(arr, coarse, axis))
    for vp, cp in ((None, None), (perm, coarse)):
        got = conv.convert(tfvars, cfg, vertex_perm=vp, coarse_perm=cp)
        _same_tree(got, jconv.convert(jtfvars, jcfg, vertex_perm=vp, coarse_perm=cp))
    _same_tree(conv.convert(tfvars, cfg), params)  # the inverse of synthesize
    flat, jflat = conv.flatten_tree(got), jax_flatten_tree(got)
    assert sorted(flat) == sorted(jflat)
    model = CAPE(cfg)
    conv.verify_against_template(got, model, ctx)
    del got["generator"]["decoder"]["out"]["b"]
    with pytest.raises(KeyError, match=r"\['out'\]\['b'\]"):
        conv.verify_against_template(got, model, ctx)
    got = conv.convert(tfvars, cfg)
    got["cond_pose"]["fc1"]["bias"] = got["cond_pose"]["fc1"]["bias"][:-1]
    with pytest.raises(ValueError, match="shape mismatch"):
        conv.verify_against_template(got, model, ctx)
    w = np.random.default_rng(0).standard_normal((3, 5, 7))
    np.testing.assert_array_equal(conv.cheb_to_ours(conv.ours_to_tf_cheb(w), 3), w)


def test_converter_reads_a_real_saver_file(flagship_tree, tmp_path):
    """A real tf.train.Saver file written by the JAX package's
    write_tf_checkpoint (with an optimizer slot and a global step) is read
    by the port's read_tf_checkpoint without the slots; the converter's
    CLI writes an npz that core.bridge loads as the JAX converter's tree."""
    pytest.importorskip("tensorflow")
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu.tools import tf_ckpt_converter as jconv
    from cape_tpu_torch.tools import tf_ckpt_converter as conv

    cfg, _, params, perm, coarse = flagship_tree
    tfvars = conv.synthesize_reference_vars(params, cfg)
    saved = jconv.write_tf_checkpoint(tfvars, str(tmp_path / "tf" / "model"), global_step=100,
                                      fake_slots=True)
    got = conv.read_tf_checkpoint(saved)
    assert sorted(got) == sorted(tfvars)
    for k in tfvars:
        np.testing.assert_array_equal(got[k], tfvars[k], err_msg=k)
    assert sorted(conv.read_tf_checkpoint(str(tmp_path / "tf"))) == sorted(tfvars)

    out = str(tmp_path / "converted.npz")
    conv.main([saved, "--config", FLAGSHIP, "--out", out, "--verify"])
    want = jconv.convert(got, jax_load_config(FLAGSHIP), vertex_perm=perm, coarse_perm=coarse)
    sd = load_jax_checkpoint(out)
    wflat = {k.replace("']['", ".").strip("[']"): v
             for k, v in conv.flatten_tree(want).items()}
    assert sorted(sd) == sorted(wflat)
    for k, v in wflat.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


# ---------------------------------------------------------------- the lab
def test_perf_lab_artifact_prints_its_line(icosphere, monkeypatch, capsys):
    """`perf_lab artifact` on the CPU with the CUDA-event timer stubbed:
    one JSON line with the JAX subcommand's keys (and the device); --batch
    is refused for a fixed-batch artifact, as in JAX."""
    from cape_tpu_torch.tools import perf_lab

    path = icosphere[3]
    timed = []

    def stub(routes, **kw):
        for fn in routes.values():
            timed.append(tuple(fn().shape))
        return dict.fromkeys(routes, 2.0)

    monkeypatch.setattr(perf_lab, "time_routes", stub)
    perf_lab.main(["artifact", path, "--device", "cpu"])
    (line,) = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert set(line) == {"bench", "path", "batch", "quantize", "constants_dtype", "inner",
                         "decode_ms_per_call", "decode_meshes_per_sec",
                         "single_call_decode_ms_incl_dispatch", "device"}
    assert line["bench"] == "artifact" and line["batch"] == 4 and line["device"] == "cpu"
    assert line["decode_ms_per_call"] == 2.0 and line["decode_meshes_per_sec"] == 2000.0
    assert line["single_call_decode_ms_incl_dispatch"] > 0 and timed == [(4, 258, 3)]
    with pytest.raises(SystemExit, match="fixed-batch artifact"):
        perf_lab.main(["artifact", path, "--device", "cpu", "--batch", "3"])


# ---------------------------------------------------------------- the drill
def test_artifact_drill_end_to_end(tmp_path, capsys):
    """pack -> train -> accept -> convert -> demo -> deploy on a narrow
    flagship preset (nf=8), --device cpu: every stage says ok and leaves
    its artifact."""
    from cape_tpu_torch.tools.artifact_drill import main as drill_main

    lines = open(FLAGSHIP).read().splitlines()
    narrow = {"nf": 8, "reduce_dim": 8, "nz": 8, "nz_cond": 8, "nz_cond2": 4}
    lines = [f"{k}: {narrow[k]}" if (k := s.split(":")[0]) in narrow else s for s in lines]
    preset = tmp_path / "narrow.yaml"
    preset.write_text("\n".join(lines) + "\n")
    root = tmp_path / "drill"
    drill_main(["--workdir", str(root), "--config", str(preset), "--device", "cpu"])
    out = capsys.readouterr().out
    for stage in ("pack", "train", "accept", "convert", "demo", "deploy"):
        assert f"DRILL {stage} ok" in out, stage
    assert json.loads(out.strip().splitlines()[-1])["drill"] == "ok"
    assert (root / "datasets").is_dir()
    assert list((root / "drill_run" / "checkpoints").glob("ckpt_*.npz"))
    assert (root / "converted_params.npz").is_file()
    assert list((root / "demo_results").rglob("*.obj"))
    em = ExportedModel.load(str(root / "drill_run.capex"), device="cpu")
    assert em.meta["quantize"] == "int8" and em.meta["constants_dtype"] == "bfloat16"
    assert em.meta["batch_size"] == 4 and em.meta["nz"] == 8
