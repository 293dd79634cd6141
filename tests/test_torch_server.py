"""The port's server beyond one request at a time, on the CPU against the
JAX package: the micro-batcher, coalesced responses against per-request
ones, drain, /metrics text, the /viewer page bytes, the GMM prior
(sampling, log density, the EM fitter) and /sample prior="gmm"."""

import concurrent.futures
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cape_tpu.apps.inference import InferenceEngine as JaxEngine
from cape_tpu.core.config import CAPEConfig as JaxConfig
from cape_tpu.models.cape import CAPE as JaxCAPE
from cape_tpu.models.gmm import GMM as JaxGMM
from cape_tpu.models.gmm import fit_gmm as jax_fit_gmm
from cape_tpu_torch.apps.inference import InferenceEngine
from cape_tpu_torch.core import prng
from cape_tpu_torch.core.bridge import from_jax_params
from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.models.gmm import GMM, fit_gmm

torch.set_num_threads(1)

SMALL = dict(
    name="server_test", nz=8, nz_cond=8, nz_cond2=4, nf=8, use_res_block=False,
    use_res_block_dec=True, affine=True, reduce_dim=8, batch_size=4,
)


@pytest.fixture(scope="module")
def engines(small_mesh):
    """The JAX and the port engine over the same icosphere model and
    params at batch 4 (the port's kernel wrappers run their plain version
    on the CPU)."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, CAPEConfig(**SMALL).ds_factors)
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    edges = vertices_per_edge(faces, len(verts))
    jctx = jax_context(pyr, pyr_d, edges, verts, padded=True)
    jmodel = JaxCAPE(JaxConfig(**SMALL))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0), jctx)
    jparams = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype), shapes
    )
    ctx = build_graph_context(pyr, pyr_d, edges, verts, padded=True)
    model = CAPE(CAPEConfig(**SMALL)).init_params(torch.Generator().manual_seed(0), ctx)
    model.load_state_dict(from_jax_params(jparams))
    return JaxEngine(jmodel, jctx, jparams, batch_size=4), InferenceEngine(model, ctx, 4)


@pytest.fixture(scope="module")
def latent_gmm():
    """An 8-dim prior fitted by both packages' EM on the same latents."""
    x = np.random.default_rng(5).standard_normal((120, 8)) * np.linspace(0.5, 2.0, 8)
    return fit_gmm(x, n_components=3, n_iter=10, seed=0), jax_fit_gmm(x, 3, 10, 0)


def _start(ms_httpd):
    httpd, ms = ms_httpd
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, ms, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _req(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_micro_batcher_unit():
    """Rows coalesce up to capacity, each future gets exactly its own rows
    back in order, a multi-row request spans correctly, and a failing
    device fn rejects every waiting future instead of hanging them."""
    from cape_tpu_torch.apps.server import _MicroBatcher

    calls = []

    def fn(a, b):
        calls.append(len(a))
        return a * 2.0, b + 1.0

    mb = _MicroBatcher(fn, capacity=4, window_ms=30.0, name="unit")
    futs = [mb.submit([np.full((1, 3), i, np.float32), np.full((1, 2), i, np.float32)])
            for i in range(6)]
    for i, f in enumerate(futs):
        a2, b1 = f.result(timeout=30)
        np.testing.assert_array_equal(a2, np.full((1, 3), 2.0 * i))
        np.testing.assert_array_equal(b1, np.full((1, 2), i + 1.0))
    assert mb.requests == 6 and mb.calls == len(calls)
    assert all(c <= 4 for c in calls)

    big = mb.submit([np.arange(9, dtype=np.float32).reshape(3, 3), np.zeros((3, 2), np.float32)])
    small = mb.submit([np.full((1, 3), 7, np.float32), np.zeros((1, 2), np.float32)])
    np.testing.assert_array_equal(big.result(timeout=30)[0],
                                  2.0 * np.arange(9, dtype=np.float32).reshape(3, 3))
    np.testing.assert_array_equal(small.result(timeout=30)[0], np.full((1, 3), 14.0))

    def bad(a, b):
        raise RuntimeError("device on fire")

    mbad = _MicroBatcher(bad, capacity=4, window_ms=5.0, name="unit-bad")
    f1 = mbad.submit([np.zeros((1, 3), np.float32), np.zeros((1, 2), np.float32)])
    f2 = mbad.submit([np.zeros((1, 3), np.float32), np.zeros((1, 2), np.float32)])
    for f in (f1, f2):
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=30)


def test_coalesced_responses_match_per_request_and_jax(engines):
    """Concurrent single-row /sample (seeds 1, 2, 1, 2, ...), /encode and
    deterministic /reconstruct through the micro-batched server: every
    response equals the same request answered by a micro_batch=False
    server on the same engine (atol 1e-5, as the JAX suite) and the JAX
    engine's answer (1e-4 * max|ref|), and the batchers coalesced."""
    from cape_tpu_torch.apps.server import serve

    jeng, eng = engines
    nv = eng.ctx.level_sizes[0]
    rng = np.random.default_rng(3)
    disp = (0.05 * rng.standard_normal((8, nv, 3))).astype(np.float32)
    pose = rng.standard_normal((8, 126)).astype(np.float32)
    clo = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]

    def sample(base, i):
        return _req(base, "/sample", {"n": 1, "seed": 1 + i % 2, "pose": pose[i:i + 1].tolist(),
                                      "clo": clo[i:i + 1].tolist()})

    def mixed(base, i):
        path = "/encode" if i % 2 == 0 else "/reconstruct"
        return _req(base, path, {"disp": disp[i:i + 1].tolist(), "pose": pose[i:i + 1].tolist(),
                                 "clo": clo[i:i + 1].tolist()})

    results = {}
    for mode in (True, False):
        httpd, ms, thread, base = _start(serve(eng, "127.0.0.1", 0, micro_batch=mode))
        try:
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                s = list(ex.map(lambda i: sample(base, i), range(8)))
                m = list(ex.map(lambda i: mixed(base, i), range(8)))
            results[mode] = (s, m, ms.batcher_counts())
        finally:
            _stop(httpd, thread)
    (s_mb, m_mb, counts), (s_one, m_one, none) = results[True], results[False]
    assert none is None
    for i in range(8):
        for (st_a, a), (st_b, b) in ((s_mb[i], s_one[i]), (m_mb[i], m_one[i])):
            assert st_a == st_b == 200
            for k in a:
                np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), rtol=0, atol=1e-5,
                                           err_msg=f"{i} {k}")
    # the per-request answers are the JAX engine's
    zm, *_ = jeng.encode(disp, pose, clo)
    rec = jeng.autoencode(disp, pose, clo, sample=False)
    for i in range(8):
        got = np.asarray(m_mb[i][1]["z_mean" if i % 2 == 0 else "disp"], np.float32)
        want = (zm if i % 2 == 0 else rec)[i:i + 1]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert counts["decode_requests"] == 8 + 4 and counts["encode_requests"] == 8
    assert counts["decode_calls"] < counts["decode_requests"]
    assert counts["encode_calls"] < counts["encode_requests"]


def test_same_seed_is_bit_equal_under_load(engines):
    """One seed repeated across threads, with other seeds in between: the
    coalesced server gives the same bytes for it every time."""
    from cape_tpu_torch.apps.server import serve

    _, eng = engines
    httpd, ms, thread, base = _start(serve(eng, "127.0.0.1", 0))
    body = lambda seed: {"n": 1, "seed": seed, "pose": np.zeros((1, 126)).tolist(),
                         "clo": np.eye(4)[:1].tolist()}
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
            out = list(ex.map(lambda s: _req(base, "/sample", body(s)), [5, 1, 5, 2, 5, 3]))
    finally:
        _stop(httpd, thread)
    assert all(st == 200 for st, _ in out)
    for i in (2, 4):
        np.testing.assert_array_equal(out[i][1]["disp"], out[0][1]["disp"])
    assert not np.allclose(out[0][1]["disp"], out[1][1]["disp"])


def test_drain_waits_for_inflight_requests(engines):
    """drain() blocks while a tracked request is open and returns promptly
    once it closes; a served request leaves nothing in flight."""
    from cape_tpu_torch.apps.server import ModelServer, serve

    _, eng = engines
    ms = ModelServer(eng, micro_batch=False)
    assert ms.drain(timeout=0.1)
    release, started = threading.Event(), threading.Event()

    def busy():
        with ms.track_request():
            started.set()
            release.wait()

    t = threading.Thread(target=busy)
    t.start()
    assert started.wait(5)
    assert not ms.drain(timeout=0.2)
    release.set()
    assert ms.drain(timeout=5.0)
    t.join(timeout=5)

    httpd, ms, thread, base = _start(serve(eng, "127.0.0.1", 0))
    try:
        ms.draining = True
        req = urllib.request.Request(base + "/health")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers["Connection"] == "close"
        assert ms.drain(timeout=5.0, grace=0.05)
    finally:
        _stop(httpd, thread)


def test_metrics_text_matches_jax(engines):
    """For the same recorded stats and batcher counts the port's
    Prometheus text is the JAX server's, byte for byte, label escaping
    included."""
    from cape_tpu.apps.server import ModelServer as JaxServer
    from cape_tpu_torch.apps.server import ModelServer

    jeng, eng = engines
    servers = [ModelServer(eng), JaxServer(jeng)]
    for ms in servers:
        for ep, t, ok in (("POST /sample", 3.25, True), ("POST /sample", 7.5, False),
                          ('GET /we"ird\\path\n', 1.0, True), ("(unrouted)", 0.5, False)):
            ms.stats.record(ep, t, ok)
        for i, b in enumerate((ms._embed_b, ms._encode_b, ms._decode_b)):
            b.calls, b.requests = i + 1, 2 * i + 5
    text = servers[0].metrics_text()
    assert text == servers[1].metrics_text()
    assert 'cape_microbatch_device_calls_total{stage="decode"} 3' in text
    assert 'endpoint="GET /we\\"ird\\\\path\\n"' in text
    for line in text.splitlines():
        if not line.startswith("#"):
            name_labels, value = line.rsplit(" ", 1)
            float(value)
            assert name_labels.startswith("cape_") and name_labels.endswith("}")


def test_viewer_page_bytes_match_jax(engines, small_mesh):
    """GET /viewer for a model given its mesh (viewer_mesh=): the page the
    port serves is the JAX server's page, byte for byte, and is cached."""
    from cape_tpu.apps.server import ModelServer as JaxServer
    from cape_tpu_torch.apps.server import ModelServer, serve

    jeng, eng = engines
    _, faces = small_mesh
    nv = eng.ctx.level_sizes[0]
    rng = np.random.default_rng(2)
    mesh = (faces, rng.standard_normal((nv, 3)).astype(np.float32),
            rng.random((nv, 3)).astype(np.float32) + 0.5,
            rng.standard_normal((2, 126)).astype(np.float32))
    want = JaxServer(jeng, micro_batch=False, viewer_mesh=mesh).viewer_html()
    page = ModelServer(eng, micro_batch=False, viewer_mesh=mesh).viewer_html()
    assert page == want and b'fetch("/sample"' in page
    httpd, ms, thread, base = _start(serve(eng, "127.0.0.1", 0, viewer_mesh=mesh))
    try:
        for _ in range(2):
            with urllib.request.urlopen(base + "/viewer", timeout=60) as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"].startswith("text/html")
                assert resp.read() == want
    finally:
        _stop(httpd, thread)


def test_gmm_matches_jax():
    """The shipped prior: sample_np bit-equal for a numpy seed, sample(key)
    within 1e-6 with the same components, log_prob within 1e-5 relative."""
    g, jg = GMM.load_pretrained(), JaxGMM.load_pretrained()
    for name in ("weights", "means", "covariances", "chols"):
        np.testing.assert_array_equal(getattr(g, name), np.asarray(getattr(jg, name)), name)
    for seed in (0, 3):
        np.testing.assert_array_equal(g.sample_np(np.random.default_rng(seed), 7),
                                      jg.sample_np(np.random.default_rng(seed), 7))
    for seed in (0, 1, 123):
        z = g.sample(prng.PRNGKey(seed), 16)
        want = np.asarray(jg.sample(jax.random.PRNGKey(seed), 16))
        assert z.shape == (16, 18) and z.dtype == np.float32
        np.testing.assert_allclose(z, want, rtol=0, atol=1e-6)
    x = g.sample_np(np.random.default_rng(9), 12)
    lp = g.log_prob(x)
    assert lp.dtype == torch.float32 and lp.shape == (12,)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jg.log_prob(x)), rtol=1e-5)


def test_fit_gmm_is_bit_equal_and_round_trips(latent_gmm, tmp_path):
    g, jg = latent_gmm
    for name in ("weights", "means", "covariances", "chols"):
        np.testing.assert_array_equal(getattr(g, name), np.asarray(getattr(jg, name)), name)
    path = str(tmp_path / "gmm.npz")
    np.savez(path, weights=g.weights, means=g.means, covariances=g.covariances)
    back, jback = GMM.from_npz(path), JaxGMM.from_npz(path)
    assert back.means.shape == (3, 8)
    for name in ("weights", "means", "covariances", "chols"):
        np.testing.assert_array_equal(getattr(back, name), np.asarray(getattr(jback, name)), name)


def test_sample_gmm_prior_matches_jax(engines, latent_gmm):
    """/sample prior="gmm" on a server given a prior of the model's nz:
    z is the JAX server's host draw (sample_np of the seed), the meshes
    the JAX engine's decode of it; a prior of another dim is a 400."""
    from cape_tpu_torch.apps.server import serve

    jeng, eng = engines
    g, jg = latent_gmm
    httpd, ms, thread, base = _start(serve(eng, "127.0.0.1", 0, gmm=g))
    pose, clo = np.zeros((1, 126), np.float32), np.eye(4, dtype=np.float32)[1:2]
    try:
        assert _req(base, "/health")[1]["gmm_prior"] is True
        status, out = _req(base, "/sample", {"n": 3, "seed": 4, "prior": "gmm",
                                             "pose": pose.tolist(), "clo": clo.tolist()})
        ms.gmm = GMM.load_pretrained()
        bad = _req(base, "/sample", {"n": 1, "prior": "gmm", "pose": pose.tolist(),
                                     "clo": clo.tolist()})
    finally:
        _stop(httpd, thread)
    assert status == 200
    z = np.asarray(out["z"], np.float32)
    np.testing.assert_array_equal(z, jg.sample_np(np.random.default_rng(4), 3))
    y, y2 = jeng.encode_only_condition(pose, clo)
    y, y2 = np.repeat(y, 3, 0), np.repeat(y2, 3, 0)
    want = jeng.decode(np.concatenate([z, y, y2], -1), y, y2)
    got = np.asarray(out["disp"], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert bad[0] == 400 and "18-dim" in bad[1]["error"]


def test_handle_fuzz_never_500(engines):
    """Seeded fuzz over the request surface (the JAX suite's): any garbage
    body comes back as a 4xx (or a 200 when it happens to be valid), never
    a 500."""
    from cape_tpu_torch.apps.server import ModelServer

    _, eng = engines
    cfg = eng.model.cfg
    ms = ModelServer(eng, micro_batch=False)
    rng = np.random.default_rng(42)

    def rand_val(depth=0):
        k = int(rng.integers(0, 10))
        if k == 0:
            return None
        if k == 1:
            return float(rng.standard_normal()) * 10 ** int(rng.integers(0, 12))
        if k == 2:
            return int(rng.integers(-(2**40), 2**40))
        if k == 3:
            return str(rng.choice(["", "abc", "gmm", "normal", "NaN"]))
        if k == 4:
            return bool(rng.integers(0, 2))
        if k == 5:
            return float("nan") if rng.integers(0, 2) else float("inf")
        if k == 6 and depth < 2:
            return [rand_val(depth + 1) for _ in range(int(rng.integers(0, 4)))]
        if k == 7 and depth < 2:
            return {"x": rand_val(depth + 1)}
        if k == 8:
            shape = tuple(int(rng.integers(0, 5)) for _ in range(int(rng.integers(1, 4))))
            return rng.standard_normal(shape).tolist()
        width = int(rng.choice([cfg.cond_dim, cfg.cond2_dim, cfg.nz, 3]))
        return np.zeros((1, width), np.float32).tolist()

    keys = np.array(["pose", "clo", "disp", "z", "z_total", "y", "y2", "n", "seed",
                     "prior", "sample"])
    paths = ["/encode", "/decode", "/reconstruct", "/sample", "/nope"]
    for i in range(300):
        nk = int(rng.integers(0, 6))
        body = {str(k): rand_val() for k in rng.choice(keys, size=nk, replace=False)}
        status, resp = ms.handle("POST", paths[i % len(paths)], body)
        assert status in (200, 400, 404), (status, resp, body)
