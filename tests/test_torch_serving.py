"""Parity of the PyTorch port's serving path with the JAX package on the
CPU: the preset reader, the inference engine in natural vertex order, the
HTTP server (JSON and npz wires), checkpoint restore, and the import
boundary (the port loads no JAX, flax or yaml)."""

import dataclasses
import glob
import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cape_tpu.apps.inference import InferenceEngine as JaxEngine
from cape_tpu.core.config import CAPEConfig as JaxConfig
from cape_tpu.core.config import load_config as jax_load_config
from cape_tpu.models.cape import CAPE as JaxCAPE
from cape_tpu_torch.apps.inference import InferenceEngine
from cape_tpu_torch.core.bridge import from_jax_params
from cape_tpu_torch.core.config import CAPEConfig, load_config
from cape_tpu_torch.models.cape import CAPE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")

SMALL = dict(
    name="serving_test", nz=8, nz_cond=8, nz_cond2=4, nf=8, use_res_block=False,
    use_res_block_dec=True, affine=True, reduce_dim=8, batch_size=4,
)


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))), ids=os.path.basename
)
def test_preset_reader_matches_pyyaml(path):
    """The port reads every preset as the JAX package does with PyYAML."""
    assert dataclasses.asdict(load_config(path)) == dataclasses.asdict(jax_load_config(path))


def test_preset_reader_scalars(tmp_path):
    from cape_tpu_torch.core.config import read_preset

    p = tmp_path / "p.yaml"
    p.write_text("# c\na: 1\nb: 0.5  # note\nc: yes\nd:\ne: 'x y'\nf: 1e-3\ng: ~\n")
    assert read_preset(str(p)) == {
        "a": 1, "b": 0.5, "c": True, "d": None, "e": "x y", "f": "1e-3", "g": None
    }
    p.write_text("a:\n  b: 1\n")
    with pytest.raises(ValueError, match="nested"):
        read_preset(str(p))


@pytest.fixture(scope="module")
def engines(small_mesh):
    """The JAX and the port engine over the same icosphere model and
    params, batch 4, with the large-batch route lowered to batch 4 in both
    packages (the port runs its band-apply plain version on the CPU)."""
    import cape_tpu.ops.cheb as jax_cheb
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu_torch.ops import cheb
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, CAPEConfig(**SMALL).ds_factors)
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    jctx = jax_context(pyr, pyr_d, vertices_per_edge(faces, len(verts)), verts, padded=True)
    jmodel = JaxCAPE(JaxConfig(**SMALL))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0), jctx)
    jparams = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype), shapes
    )
    ctx = build_graph_context(pyr, pyr_d, vertices_per_edge(faces, len(verts)), verts, padded=True)
    model = CAPE(CAPEConfig(**SMALL)).init_params(torch.Generator().manual_seed(0), ctx)
    model.load_state_dict(from_jax_params(jparams))

    saved = [(m, m.VM_MIN_BATCH, m.VM_MIN_COLS) for m in (jax_cheb, cheb)]
    for m in (jax_cheb, cheb):
        m.VM_MIN_BATCH, m.VM_MIN_COLS = 4, 12
    try:
        yield JaxEngine(jmodel, jctx, jparams, batch_size=4), InferenceEngine(model, ctx, 4)
    finally:
        for m, b, c in saved:
            m.VM_MIN_BATCH, m.VM_MIN_COLS = b, c


def _inputs(n, nv, seed):
    rng = np.random.default_rng(seed)
    disp = (0.05 * rng.standard_normal((n, nv, 3))).astype(np.float32)
    pose = rng.standard_normal((n, 126)).astype(np.float32)
    clo = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return disp, pose, clo


def _close(got, want, name=""):
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_engine_matches_jax_engine(engines):
    """encode, decode (one condition row broadcast over 5 z) and the
    deterministic autoencode, in natural vertex order, 5 rows = 2 padded
    device calls. CPU tensors take the plain version: no kernel launch."""
    from cape_tpu_torch.ops import kernels

    jeng, eng = engines
    nv = eng.ctx.level_sizes[0]
    disp, pose, clo = _inputs(5, nv, 1)
    routes, launches = kernels.counts["route.v3"], kernels.counts["band_apply.conv"]
    got = eng.encode(disp, pose, clo)
    for name, g, w in zip(("z_mean", "z_logvar", "y", "y2"), got, jeng.encode(disp, pose, clo)):
        _close(g, np.asarray(w), name)
    zt = np.random.default_rng(2).standard_normal((5, 20)).astype(np.float32)
    y, y2 = got[2][:1], got[3][:1]
    _close(eng.decode(zt, y, y2), jeng.decode(zt, y, y2), "decode")
    _close(eng.autoencode(disp, pose, clo), jeng.autoencode(disp, pose, clo), "autoencode")
    assert eng.calls["encode"] >= 4 and eng.calls["decode"] >= 4
    assert kernels.counts["route.v3"] > routes
    assert kernels.counts["band_apply.conv"] == launches == 0


def test_sampled_autoencode_is_seeded_and_batch_independent(engines):
    """sample=True draws the JAX engine's row-keyed eps (row i from
    fold_in(PRNGKey(seed), i)): the port's sampled reconstruction equals
    the JAX engine's for the same integer seed, repeats bit for bit, moves
    with the seed, and does not depend on the engine's batch size."""
    jeng, eng = engines
    disp, pose, clo = _inputs(5, eng.ctx.level_sizes[0], 3)
    a = eng.autoencode(disp, pose, clo, rng=7, sample=True)
    _close(a, jeng.autoencode(disp, pose, clo, rng=7, sample=True), "JAX engine, seed 7")
    np.testing.assert_array_equal(a, eng.autoencode(disp, pose, clo, rng=7, sample=True))
    assert not np.allclose(a, eng.autoencode(disp, pose, clo, rng=8, sample=True))
    # the same draw whatever the engine's batch size (here 3 calls of 2 rows)
    eng2 = InferenceEngine(eng.model, eng.ctx, 2)
    _close(eng2.autoencode(disp, pose, clo, rng=7, sample=True), a, "batch 2")


@pytest.fixture(scope="module")
def server(engines):
    from cape_tpu_torch.apps.server import serve

    _, eng = engines
    httpd, ms = serve(eng, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(base, path, body, npz=False):
    if npz:
        buf = io.BytesIO()
        np.savez(buf, **body)
        data, ctype = buf.getvalue(), "application/x-npz"
    else:
        data, ctype = json.dumps(body).encode(), "application/json"
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw, status = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    if npz:
        with np.load(io.BytesIO(raw)) as z:
            return status, {k: z[k] for k in z}
    return status, json.loads(raw)


def test_server_health_and_sample_match_jax(engines, server):
    jeng, eng = engines
    with urllib.request.urlopen(server + "/health", timeout=30) as resp:
        info = json.loads(resp.read())
    assert info["num_verts"] == eng.ctx.level_sizes[0] and info["batch_size"] == 4
    _, pose, clo = _inputs(1, 1, 4)
    body = {"pose": pose.tolist(), "clo": clo.tolist(), "n": 6, "seed": 11}
    status, out = _post(server, "/sample", body)
    assert status == 200
    z = np.asarray(out["z"], np.float32)
    # the JAX server's host draw (cape_tpu/apps/server.py, handle_sample)
    np.testing.assert_array_equal(
        z, np.random.default_rng(11).standard_normal((6, 8)).astype(np.float32)
    )
    y, y2 = jeng.encode_only_condition(pose, clo)
    y, y2 = np.repeat(y, 6, 0), np.repeat(y2, 6, 0)
    want = jeng.decode(np.concatenate([z, y, y2], -1), y, y2)
    _close(np.asarray(out["disp"], np.float32), want, "sample")

    status, out_npz = _post(server, "/sample", {"pose": pose, "clo": clo, "n": 6, "seed": 11},
                            npz=True)
    assert status == 200 and out_npz["disp"].dtype == np.float32
    np.testing.assert_array_equal(out_npz["disp"], np.asarray(out["disp"], np.float32))
    np.testing.assert_array_equal(out_npz["z"], z)


def test_server_errors_and_unported_routes(server):
    """Client errors are 400s: prior='gmm' on a server without a prior, a
    wrong pose width. GET /metrics answers the Prometheus text, and GET
    /viewer answers 404 for a mesh that is not the SMPL template (the
    icosphere here); the errors are counted in /stats."""
    status, out = _post(server, "/sample", {"pose": [[0.0] * 126], "clo": [[1, 0, 0, 0]],
                                            "prior": "gmm"})
    assert status == 400 and "no GMM prior" in out["error"]
    status, out = _post(server, "/sample", {"pose": [[0.0] * 3], "clo": [[1, 0, 0, 0]]})
    assert status == 400 and "pose" in out["error"]
    with urllib.request.urlopen(server + "/metrics", timeout=30) as resp:
        assert resp.status == 200 and resp.headers["Content-Type"].startswith("text/plain")
        assert 'cape_model_info{model="serving_test"' in resp.read().decode()
    try:
        urllib.request.urlopen(server + "/viewer", timeout=30)
        raise AssertionError("/viewer answered 200")
    except urllib.error.HTTPError as e:
        assert e.code == 404 and "no mesh topology" in json.loads(e.read())["error"]
    with urllib.request.urlopen(server + "/stats", timeout=30) as resp:
        stats = json.loads(resp.read())
    assert stats["POST /sample"]["errors"] >= 2
    assert stats["(micro_batch)"]["decode_requests"] >= 1


def test_restore_params_from_jax_checkpoint(engines, tmp_path):
    """restore_params reads a train-state checkpoint written by the JAX
    package's save_checkpoint: the port's params equal the JAX params."""
    from cape_tpu.train.checkpoint import save_checkpoint
    from cape_tpu.train.optim import build_optimizer, create_train_state
    from cape_tpu_torch.apps.main import restore_params
    from cape_tpu_torch.core.bridge import to_jax_params

    jeng, eng = engines
    cfg = JaxConfig(**SMALL)
    tx, _, _ = build_optimizer(cfg, steps_per_epoch=1)
    state = create_train_state(jeng.params, tx)
    save_checkpoint(str(tmp_path / cfg.name / "checkpoints"), state, step=3)
    model = restore_params(CAPEConfig(**SMALL), CAPE(CAPEConfig(**SMALL)), eng.ctx, str(tmp_path))
    got = to_jax_params(model)
    want = jax.device_get(jeng.params)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_want) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat_want:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=jax.tree_util.keystr(path))


def test_import_loads_no_jax_flax_or_yaml():
    """Every module of the port, and chip_smoke.py, imports without jax,
    flax, optax, yaml or tensorflow (the converter imports it only inside
    its two TF I/O functions), and without any module of the JAX package
    (`cape_tpu` or `cape_tpu.*`)."""
    code = (
        "import importlib, pkgutil, sys, cape_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(cape_tpu_torch.__path__, 'cape_tpu_torch.')]\n"
        "assert 'cape_tpu_torch.train.loop' in names and 'cape_tpu_torch.losses' in names, names\n"
        "assert 'cape_tpu_torch.meshops.assets' in names, names\n"
        "new = ['core.prng', 'apps.client', 'apps.demos', 'apps.simple_demo', 'models.gmm',\n"
        "       'models.summary', 'meshops.viewer', 'meshops.render', 'smpl.joints',\n"
        "       'smpl.rodrigues', 'smpl.lbs', 'tools.fit_latent_gmm', 'ops.norm',\n"
        "       'data.packer', 'data.dataset_configs', 'train.tb_events', 'train.metrics',\n"
        "       'meshops.normals', 'tools.plot_metrics', 'tools.dtype_ablation',\n"
        "       'tools.opt_state_ab', 'tools.acceptance', 'tools.export_model',\n"
        "       'tools.tf_ckpt_converter', 'tools.artifact_drill', 'tools.endurance',\n"
        "       'tools.flagship', 'meshops.toy', 'meshops.native_aabb', 'parallel.mesh',\n"
        "       'parallel.multihost']\n"
        "assert not [n for n in new if 'cape_tpu_torch.' + n not in names], names\n"
        "for n in names + ['chip_smoke']: importlib.import_module(n)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m in ('jax', 'flax', 'optax', 'yaml', 'tensorflow', 'cape_tpu')\n"
        "             or m.startswith('cape_tpu.')))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """With no GPU, the server's and the train mode's CLI and `run()` raise
    RuntimeError naming `--device cpu` when the CPU was not asked for, before
    they build anything; `--device cpu` passes the check (the CLI test above
    serves on the CPU)."""
    from cape_tpu_torch.apps import main as app_main
    from cape_tpu_torch.apps import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(app_main, "build_context", lambda *a, **k: built.append(1))
    args = ["--config", FLAGSHIP, "--name", "x"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        server.main(args + ["--fresh-init"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        app_main.main(args + ["--mode", "train", "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app_main.run(CAPEConfig(**SMALL), str(tmp_path))
    assert not built
    app_main.require_device("cpu")


def test_server_cli_serves_and_stops_on_sigterm():
    """`python -m cape_tpu_torch.apps.server` with a fresh init on the CPU
    (the flagship pyramid at nf=8): it prints its bound port, answers
    /health, and exits 0 on SIGTERM."""
    cmd = [
        sys.executable, "-m", "cape_tpu_torch.apps.server",
        "--config", FLAGSHIP,
        "--name", "cli_smoke", "--fresh-init", "--device", "cpu", "--port", "0",
        "--batch_size", "2", "--nf", "8", "--reduce_dim", "8", "--nz", "8",
        "--nz_cond", "8", "--nz_cond2", "4",
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    # a server that hangs before printing its port is killed, ending the read
    watchdog = threading.Timer(180, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        assert lines and lines[-1].startswith("serving cli_smoke on http://"), lines
        base = lines[-1].split(" on ")[1].strip()
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            info = json.loads(resp.read())
        assert info["num_verts"] == 6890 and info["batch_size"] == 2 and info["nz"] == 8
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_unported_server_options_raise(engines):
    """Micro-batching is the default (and micro_batch=False the opt-out);
    --data_parallel 2 on the CPU asks for more devices than the host has and
    raises the over-request ValueError before anything is built (the DP
    engine itself is tests/test_torch_parallel.py's); --artifact, ported,
    refuses the checkpoint mode's flags (exit 2)."""
    from cape_tpu_torch.apps.server import main, serve

    _, eng = engines
    httpd, ms = serve(eng, "127.0.0.1", 0)
    httpd.server_close()
    assert ms.batcher_counts() == {f"{s}_{k}": 0 for s in ("embed", "encode", "decode")
                                   for k in ("calls", "requests")}
    httpd, ms = serve(eng, "127.0.0.1", 0, micro_batch=False)
    httpd.server_close()
    assert ms.batcher_counts() is None
    with pytest.raises(SystemExit) as e:
        main(["--artifact", "model.capex", "--fresh-init", "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 1 devices"):
        main(["--config", FLAGSHIP,
              "--name", "x", "--data_parallel", "2", "--device", "cpu"])
