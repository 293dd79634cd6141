"""The port's evaluation path on the CPU against the JAX package: SMPL
Rodrigues maps and skinning, the architecture table, the DemoSuite
(test_model, the demo samples, the GMM prior and sweep, OBJ export),
SimpleDemo, the default /viewer page of a template model, and the CLI's
`--mode test|demo`. The model is the nz18 release preset's shape at nf=8
on the full 6890-vertex template, batch 4, with the JAX parameters."""

import os

import jax
import numpy as np
import pytest
import torch

from cape_tpu.apps.demos import DemoSuite as JaxDemoSuite
from cape_tpu.apps.demos import SimpleDemo as JaxSimpleDemo
from cape_tpu.apps.inference import InferenceEngine as JaxEngine
from cape_tpu.core.config import CAPEConfig as JaxConfig
from cape_tpu.data.synthetic import synthetic_bodydata as jax_synthetic
from cape_tpu.models.cape import CAPE as JaxCAPE
from cape_tpu_torch.apps.demos import DemoSuite, SimpleDemo
from cape_tpu_torch.apps.inference import InferenceEngine
from cape_tpu_torch.core.bridge import from_jax_params
from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.data.synthetic import synthetic_bodydata
from cape_tpu_torch.meshops.obj_io import load_obj
from cape_tpu_torch.models.cape import CAPE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NZ18 = os.path.join(ROOT, "configs", "CAPE-affineconv_nz18_pose24_clotype8_male.yaml")
SMALL = dict(
    name="demos_test", nf=8, nz=18, nz_cond=24, nz_cond2=8, use_res_block=False,
    use_res_block_dec=True, affine=True, reduce_dim=8, batch_size=4,
)


def _close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=name)


# ------------------------------------------------------------------ SMPL
@pytest.fixture(scope="module")
def rigs(small_mesh):
    from cape_tpu.smpl.lbs import SMPLModel as JaxSMPL
    from cape_tpu_torch.smpl.lbs import SMPLModel

    verts, faces = small_mesh
    return SMPLModel.synthetic(verts, faces), JaxSMPL.synthetic(verts, faces)


def test_rodrigues_matches_jax():
    from cape_tpu.smpl import rodrigues as jr
    from cape_tpu_torch.smpl import rodrigues as r

    pose = 0.8 * np.random.default_rng(0).standard_normal((5, 72))
    rot = r.pose_to_rotmats(pose)
    np.testing.assert_array_equal(rot, jr.pose_to_rotmats(pose))
    np.testing.assert_array_equal(r.rotmats_to_pose(rot), jr.rotmats_to_pose(rot))
    np.testing.assert_allclose(r.rotmats_to_pose(rot), pose, atol=1e-6)
    # near pi, the log map's other branch
    aa = np.array([[np.pi - 1e-4, 0.0, 0.0] * 24])
    np.testing.assert_allclose(r.rotmats_to_pose(r.pose_to_rotmats(aa)),
                               jr.rotmats_to_pose(jr.pose_to_rotmats(aa)), atol=1e-9)
    t = r.rodrigues(torch.from_numpy(pose.astype(np.float32)).reshape(5, 24, 3))
    want = np.asarray(jr.rodrigues(pose.astype(np.float32).reshape(5, 24, 3)))
    np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=1e-6)
    for R in t.reshape(-1, 3, 3).double():
        torch.testing.assert_close(R @ R.T, torch.eye(3, dtype=torch.float64), atol=1e-6, rtol=0)


def test_filter_cloth_pose_matches_jax():
    from cape_tpu.smpl.joints import filter_cloth_pose as jax_filter
    from cape_tpu_torch.smpl.joints import filter_cloth_pose

    rng = np.random.default_rng(3)
    for dim in (72, 216):
        x = rng.standard_normal((2, dim))
        np.testing.assert_array_equal(filter_cloth_pose(x), jax_filter(x))
    with pytest.raises(ValueError, match="72- or 216-dim"):
        filter_cloth_pose(np.zeros((1, 10)))


def test_synthetic_rig_matches_jax(rigs):
    rig, jrig = rigs
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights"):
        np.testing.assert_array_equal(getattr(rig, name).numpy(), np.asarray(getattr(jrig, name)),
                                      name)
    assert rig.parents == jrig.parents


@pytest.mark.parametrize("case", ["zero_pose", "root_rotation", "template_override", "full"])
def test_lbs_matches_jax(rigs, case):
    """lbs on the synthetic rig against the JAX package's: the identity at
    zero pose, a rigid root rotation, a per-sample template override, and a
    random pose with betas and an override (2e-5 * max|ref|, the JAX
    suite's bound against its smplx transcription)."""
    from cape_tpu.smpl.lbs import lbs as jax_lbs
    from cape_tpu_torch.smpl.lbs import lbs

    rig, jrig = rigs
    rng = np.random.default_rng(11)
    vt = rig.v_template.numpy()
    B, kw = 3, {}
    pose = np.zeros((B, 72), np.float32)
    if case == "root_rotation":
        pose[:, 2] = np.pi / 2
    if case in ("template_override", "full"):
        kw["v_template"] = (vt[None] + 0.01 * rng.standard_normal((B,) + vt.shape)).astype(
            np.float32)
    if case == "full":
        pose = (0.4 * rng.standard_normal((B, 72))).astype(np.float32)
        kw["betas"] = (0.5 * rng.standard_normal((B, 10))).astype(np.float32)
    got = lbs(rig, pose, **kw)
    assert got.dtype == torch.float32 and got.shape == (B,) + vt.shape
    want = np.asarray(jax_lbs(jrig, pose, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
    if case == "zero_pose":
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(vt, got.shape), atol=1e-5)
    if case == "template_override":
        np.testing.assert_allclose(got.numpy(), kw["v_template"], atol=1e-5)


# ------------------------------------------------------- the demo model
@pytest.fixture(scope="module")
def engines(flagship_ctx):
    from cape_tpu_torch.apps.main import build_context

    jmodel = JaxCAPE(JaxConfig(**SMALL))
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0), flagship_ctx))
    cfg = CAPEConfig(**SMALL)
    ctx = build_context(cfg)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    model.load_state_dict(from_jax_params(jparams))
    return (JaxEngine(jmodel, flagship_ctx, jparams, batch_size=4),
            InferenceEngine(model, ctx, 4, device="cpu"))


@pytest.fixture(scope="module")
def suites(engines, tmp_path_factory):
    """The two suites in lockstep: every test calls the same methods on
    both, so their numpy generators stay in step."""
    jeng, eng = engines
    root = tmp_path_factory.mktemp("demos")
    kw = dict(name="demos_test", n_sample=2, save_objs=True, smpl_model_folder="/nonexistent",
              seed=0)
    return (JaxDemoSuite(jeng, results_root=str(root / "jax"), **kw),
            DemoSuite(eng, results_root=str(root / "torch"), **kw))


def _objs(d):
    names = sorted(f for f in os.listdir(d) if f.endswith(".obj"))
    return names, [load_obj(os.path.join(d, f))[0] for f in names]


def _same_objs(jdir, tdir):
    jn, jv = _objs(jdir)
    tn, tv = _objs(tdir)
    assert jn == tn and jn
    for name, a, b in zip(jn, tv, jv):
        _close(a, b, name)
    return jn


def test_describe_matches_jax(engines):
    from cape_tpu.models.summary import describe as jax_describe
    from cape_tpu_torch.models.summary import describe

    jeng, eng = engines
    text = describe(eng.model, eng.ctx)
    assert text == jax_describe(jeng.model, jeng.ctx)
    full = describe(eng.model, eng.ctx, eng.model.params)
    assert full == jax_describe(jeng.model, jeng.ctx, jeng.params)
    assert "decoder_layer0" in text and "total: " in full


def test_test_model_matches_jax(suites):
    """test_model on the same synthetic test split (6 rows, 2 padded
    calls): the errors within 1e-4 relative of the JAX suite's (its
    sampled z is the JAX engine's row-keyed draw of seed 0), the results
    files, and the reconstruction OBJ vertices within 1e-4 * max|ref|."""
    js, ts = suites
    kw = dict(n_train=24, n_test=6, num_verts=6890, n_val=4, seed=0)
    want = js.test_model(jax_synthetic(**kw))
    got = ts.test_model(synthetic_bodydata(**kw))
    assert got["n_test"] == want["n_test"] == 6
    for k in ("euclidean_mean_m", "euclidean_std_m", "euclidean_median_m"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    with open(os.path.join(ts.results_dir, "test_results_dataset_male_4clotypes.txt")) as f:
        assert "Euclidean err mean" in f.read()
    d = "test_reconstruction_objs_dataset_male_4clotypes"
    assert len(_same_objs(os.path.join(js.results_dir, d), os.path.join(ts.results_dir, d))) == 2


@pytest.mark.parametrize("method,shape,folder", [
    ("sample_vary_clotype", (4, 2, 6890, 3), "sample_vary_clotype"),
    ("sample_vary_pose", (6, 2, 6890, 3), "sample_vary_pose"),
])
def test_demo_samples_match_jax(suites, method, shape, folder):
    js, ts = suites
    got, want = getattr(ts, method)(), getattr(js, method)()
    assert got.shape == shape
    _close(got, want, method)
    n = len(_same_objs(os.path.join(js.results_dir, folder), os.path.join(ts.results_dir, folder)))
    assert n == shape[0] * shape[1]


def test_gmm_prior_and_sweep_match_jax(suites):
    """The GMM-prior draws go through core.prng: the same latents, hence
    the same meshes, as the JAX suite's jax.random draws."""
    js, ts = suites
    got, want = ts.sample_gmm_prior(n=3), js.sample_gmm_prior(n=3)
    assert got.shape == (3, 6890, 3)
    _close(got, want, "sample_gmm_prior")
    got, want = ts.sample_gmm_sweep(n=1), js.sample_gmm_sweep(n=1)
    assert got.shape == (6, 4, 1, 6890, 3)
    _close(got, want, "sample_gmm_sweep")


def test_demo_vis_writes_viewer_pages(engines, tmp_path):
    """vis=True writes an interactive HTML page per batch (and a PNG
    contact sheet when PIL is there) and, with save_objs=False, no OBJ."""
    from cape_tpu_torch.meshops.render import HAVE_PIL

    _, eng = engines
    suite = DemoSuite(eng, name="vis_test", n_sample=1, save_objs=False, vis=True,
                      smpl_model_folder="/nonexistent", results_root=str(tmp_path), seed=0)
    suite.sample_vary_clotype()
    files = os.listdir(os.path.join(suite.results_dir, "sample_vary_clotype"))
    assert len([f for f in files if f.endswith("_viewer.html")]) == 4
    assert len([f for f in files if f.endswith("_sheet.png")]) == (4 if HAVE_PIL else 0)
    assert not [f for f in files if f.endswith(".obj")]


def test_simple_demo_matches_jax(engines, tmp_path):
    jeng, eng = engines
    want = JaxSimpleDemo(jeng, results_dir=str(tmp_path / "jax" / "demo_results"), seed=0).run()
    got = SimpleDemo(eng, results_dir=str(tmp_path / "torch" / "demo_results"), seed=0).run()
    assert got.shape == (4, 3, 6890, 3)
    _close(got, want, "SimpleDemo")


def test_default_viewer_page_matches_jax(engines):
    """GET /viewer of a 6890-vertex model with the GMM prior loaded: the
    shipped template, train stats and demo poses, byte for byte the JAX
    server's page."""
    from cape_tpu.apps.server import ModelServer as JaxServer
    from cape_tpu.models.gmm import GMM as JaxGMM
    from cape_tpu_torch.apps.server import ModelServer
    from cape_tpu_torch.models.gmm import GMM

    jeng, eng = engines
    page = ModelServer(eng, gmm=GMM.load_pretrained(), micro_batch=False).viewer_html()
    want = JaxServer(jeng, gmm=JaxGMM.load_pretrained(), micro_batch=False).viewer_html()
    assert page == want and b"HAS_GMM = true" in page


@pytest.mark.parametrize("mode", ["test", "demo"])
def test_main_modes_on_the_cpu(engines, tmp_path, monkeypatch, mode):
    """`python -m cape_tpu_torch.apps.main --mode test|demo --device cpu`
    on the nz18 release preset at nf=8: it restores the run's checkpoint
    (written by the port) bit-equal, prints the architecture table, and
    writes the test results or the demo OBJ files."""
    from cape_tpu_torch.apps import main as app_main
    from cape_tpu_torch.train.checkpoint import save_checkpoint
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState

    _, eng = engines
    monkeypatch.setattr(app_main, "synthetic_bodydata",
                        lambda **kw: synthetic_bodydata(**{**kw, "n_train": 24, "n_test": 5,
                                                           "n_val": 4}))
    save_checkpoint(str(tmp_path / "nz18" / "checkpoints"),
                    TrainState(eng.model, Optimizer(eng.model.cfg, 1), step=7), step=7)
    seen = {}
    real_run = app_main.run
    monkeypatch.setattr(app_main, "run", lambda *a, **k: seen.setdefault("r", real_run(*a, **k)))
    app_main.main(["--config", NZ18, "--name", "nz18", "--mode", mode, "--device", "cpu",
                   "--workdir", str(tmp_path), "--nf", "8", "--reduce_dim", "8",
                   "--batch_size", "4", "--demo_n_sample", "1"])
    result = seen["r"]
    restored = result.demos.engine.model.state_dict()
    for k, v in eng.model.state_dict().items():
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0, msg=k)
    run_dir = tmp_path / "nz18"
    if mode == "test":
        assert result.test["n_test"] == 5 and np.isfinite(result.test["euclidean_mean_m"])
        assert (run_dir / "test_results_dataset_male_4clotypes.txt").exists()
        # demo_n_sample 1: one reconstruction exported
        assert len(os.listdir(run_dir / "test_reconstruction_objs_dataset_male_4clotypes")) == 1
    else:
        assert result.test is None
        assert len(os.listdir(run_dir / "sample_vary_pose")) == 6
        assert len(os.listdir(run_dir / "sample_vary_clotype")) == 4
    calls = result.demos.engine.calls
    assert calls["decode"] == (2 if mode == "test" else 10)


def test_smpl_model_load_matches_jax(small_mesh, tmp_path, monkeypatch):
    """SMPLModel.load reads an SMPL-layout pickle (chumpy arrays, a scipy
    CSC joint regressor) without chumpy, as the JAX package's loader
    does, from each place the smplx layout allows."""
    import pickle
    import sys
    import types

    import scipy.sparse

    from cape_tpu.smpl.lbs import SMPLModel as JaxSMPL
    from cape_tpu.smpl.lbs import lbs as jax_lbs
    from cape_tpu_torch.smpl.lbs import SMPLModel, lbs

    class Ch:  # pickled as chumpy.ch.Ch, as the official files are
        def __init__(self, x):
            self.x = x

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    chumpy = types.ModuleType("chumpy.ch")
    chumpy.Ch = Ch
    monkeypatch.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
    monkeypatch.setitem(sys.modules, "chumpy.ch", chumpy)
    verts, faces = small_mesh
    rig = SMPLModel.synthetic(verts, faces, seed=4)
    V = len(verts)
    data = {
        "v_template": Ch(rig.v_template.double().numpy()),
        "shapedirs": Ch(rig.shapedirs.double().numpy()),
        "posedirs": rig.posedirs.double().numpy().T.reshape(V, 3, -1),
        "J_regressor": scipy.sparse.csc_matrix(rig.J_regressor.double().numpy()),
        "weights": rig.weights.double().numpy(),
        "kintree_table": np.stack([np.array([4294967295] + list(rig.parents[1:])),
                                   np.arange(24)]),
        "f": faces,
    }
    os.makedirs(tmp_path / "smpl")
    with open(tmp_path / "smpl" / "SMPL_FEMALE.pkl", "wb") as f:
        pickle.dump(data, f)
    monkeypatch.delitem(sys.modules, "chumpy.ch")
    got, want = SMPLModel.load(str(tmp_path), "female"), JaxSMPL.load(str(tmp_path), "female")
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      name)
    assert got.parents == want.parents and got.parents[1:] == rig.parents[1:]
    np.testing.assert_array_equal(got.faces, np.asarray(want.faces))
    pose = (0.3 * np.random.default_rng(1).standard_normal((2, 72))).astype(np.float32)
    out = np.asarray(jax_lbs(want, pose))
    np.testing.assert_allclose(lbs(got, pose).numpy(), out, rtol=0, atol=2e-5 * np.abs(out).max())
    with pytest.raises(FileNotFoundError, match="No SMPL model"):
        SMPLModel.load(str(tmp_path), "male")


def test_render_mesh_matches_jax(small_mesh, tmp_path):
    """The offscreen renderer (a copy): the same pixels as the JAX
    package's, and a contact sheet of the right size."""
    from cape_tpu.meshops.render import render_mesh as jax_render
    from cape_tpu_torch.meshops.render import HAVE_PIL, contact_sheet, render_mesh

    if not HAVE_PIL:
        with pytest.raises(RuntimeError, match="PIL"):
            render_mesh(*small_mesh)
        return
    from PIL import Image

    verts, faces = small_mesh
    img = render_mesh(verts, faces, size=96)
    np.testing.assert_array_equal(img, jax_render(verts, faces, size=96))
    path = contact_sheet(np.stack([verts, verts + 0.1]), faces, str(tmp_path / "s.png"), size=64)
    with Image.open(path) as sheet:
        assert sheet.size == (128, 64)


@pytest.fixture()
def small_preset(tmp_path):
    """The nz18 release preset at nf=8, batch 4, as a preset file."""
    path = tmp_path / "nz18_small.yaml"
    with open(NZ18) as f:
        text = f.read()
    path.write_text(text.replace("nf: 64", "nf: 8").replace("reduce_dim: 64", "reduce_dim: 8")
                    + "batch_size: 4\n")
    return str(path)


@pytest.mark.parametrize("source", ["random", "params"])
def test_simple_demo_cli(engines, small_preset, tmp_path, source):
    """`python -m cape_tpu_torch.apps.simple_demo --device cpu`: with
    --random (parameters of init_params(PRNGKey(cfg.seed)), JAX's) or with a bare
    parameter npz (the JAX flatten_tree keys, one bias stored as a
    converted checkpoint's (1, 1, F)), 4 clothing types x 3 samples as OBJ
    files, the meshes of SimpleDemo on the same parameters."""
    from cape_tpu_torch.apps import simple_demo
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.core.config import load_config

    _, eng = engines
    cfg = load_config(small_preset)
    model = CAPE(cfg).init_params(prng.PRNGKey(cfg.seed), eng.ctx)
    args = ["--config", small_preset, "--device", "cpu",
            "--results_dir", str(tmp_path / "cli" / "demo_results")]
    if source == "random":
        args.append("--random")
    else:
        model.load_state_dict(eng.model.state_dict())
        flat = {"".join(f"['{p}']" for p in k.split(".")): v.numpy()
                for k, v in model.state_dict().items()}
        key = "['generator']['decoder']['out']['b']"
        flat[key] = flat[key][None]
        np.savez(tmp_path / "params.npz", **flat)
        args += ["--params", str(tmp_path / "params.npz")]
    simple_demo.main(args)
    want = SimpleDemo(InferenceEngine(model, eng.ctx, 4, device="cpu"),
                      results_dir=str(tmp_path / "direct" / "demo_results"), seed=cfg.seed).run()
    from cape_tpu_torch.apps.demos import CLO_TYPES

    d = tmp_path / "cli" / "demo_results" / "sample_vary_clotype"
    assert len(os.listdir(d)) == 12
    got = [load_obj(str(d / f"clotype_{c}_{i:04d}.obj"))[0] for c in CLO_TYPES for i in range(3)]
    _close(np.stack(got), want.reshape(12, 6890, 3), "simple_demo CLI")


def test_fit_latent_gmm_tool(engines, small_preset, tmp_path, monkeypatch):
    """`python -m cape_tpu_torch.tools.fit_latent_gmm --device cpu`:
    encode the train split of a restored run, fit the EM, write an npz that
    both packages' GMM.from_npz read; the fit equals the JAX package's
    fit_gmm on the same latents."""
    from cape_tpu.models.gmm import GMM as JaxGMM
    from cape_tpu.models.gmm import fit_gmm as jax_fit_gmm
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.gmm import GMM
    from cape_tpu_torch.tools import fit_latent_gmm
    from cape_tpu_torch.train.checkpoint import save_checkpoint
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState

    _, eng = engines
    data = synthetic_bodydata(n_train=28, n_test=2, num_verts=6890, n_val=4, seed=3)
    monkeypatch.setattr(fit_latent_gmm, "load_bodydata", lambda cfg: data)
    save_checkpoint(str(tmp_path / "run" / "checkpoints"),
                    TrainState(eng.model, Optimizer(eng.model.cfg, 1), step=1), step=1)
    out = str(tmp_path / "latent_gmm.npz")
    fit_latent_gmm.main(["--config", small_preset, "--name", "run", "--workdir", str(tmp_path),
                         "--n_components", "2", "--n_iter", "5", "--out", out,
                         "--device", "cpu"])
    z_mean, *_ = eng.encode(data.disp_train, data.pose_train, data.clo_train)
    want = jax_fit_gmm(z_mean, n_components=2, n_iter=5, seed=load_config(small_preset).seed)
    got, jgot = GMM.from_npz(out), JaxGMM.from_npz(out)
    assert got.means.shape == (2, 18)
    np.testing.assert_allclose(got.means, np.asarray(want.means), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.chols, np.asarray(jgot.chols))
