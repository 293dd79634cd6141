"""The traffic generators repeat from a seed, and every seed gets the same
work in another order."""

import collections

import numpy as np
import torch

from bench_port import common
from bench_port.tests import toy

train = common.generator("train")
serve = common.generator("serve")
MIX = {**toy.TRAIN_MIX, "n_train": 40, "chunk": 16}


def test_train_split_repeats_from_a_seed():
    a = train.resident(MIX, toy.SEED, 258, "cpu")
    b = train.resident(MIX, toy.SEED, 258, "cpu")
    c = train.resident(MIX, toy.SEED + 1, 258, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["disp"], c["disp"])
    assert a["disp"].shape == (40, 258, 3) and a["pose"].shape == (40, 126)
    assert torch.equal(a["clo"].sum(1), torch.ones(40))


def test_rows_and_the_permuted_split_are_the_same_frames():
    perm = np.random.default_rng(1).permutation(258)
    whole = train.resident(MIX, toy.SEED, 258, "cpu", perm0=perm)
    idx = np.array([39, 0, 17, 17, 33])
    rows = train.rows(MIX, toy.SEED, 258, "cpu", idx)
    assert torch.equal(rows["disp"][:, perm], whole["disp"][idx])
    assert torch.equal(rows["pose"], whole["pose"][idx])


def test_pose_rows_are_rotations():
    pose = train.resident(MIX, toy.SEED, 258, "cpu")["pose"].reshape(-1, 14, 3, 3)
    eye = torch.eye(3).expand_as(pose)
    assert torch.allclose(pose @ pose.transpose(-1, -2), eye, atol=1e-5)


def test_serve_requests_repeat_and_keep_the_work():
    mix = {**toy.SERVE_MIX, "rate": 50.0, "sizes": {"1": 0.8, "8": 0.15, "32": 0.05}}
    a = serve.requests(mix, toy.SEED, 20.0, stream=1)
    b = serve.requests(mix, toy.SEED, 20.0, stream=1)
    c = serve.requests(mix, toy.SEED + 5, 20.0, stream=1)
    assert len(a) == 1000 and [r["due"] for r in a] == [r["due"] for r in b]
    assert all(np.array_equal(x["pose"], y["pose"]) and x["seed"] == y["seed"] for x, y in zip(a, b))
    # another seed: the same sizes and gaps, in another order
    count = lambda reqs: collections.Counter(r["n"] for r in reqs)
    assert count(a) == count(c) == {1: 800, 8: 150, 32: 50}
    gaps = lambda reqs: np.sort(np.diff([0.0] + [r["due"] for r in reqs]))
    assert [r["n"] for r in a] != [r["n"] for r in c]
    assert abs(a[-1]["due"] - c[-1]["due"]) < 1e-6
    assert gaps(a).mean() < 2 / mix["rate"]
    # the body carries what the server reads
    body = np.load(__import__("io").BytesIO(serve.body(a[0])))
    assert int(body["n"]) == a[0]["n"] and body["pose"].shape == (1, 126)


def test_judged_requests_include_the_largest():
    mix = {**toy.SERVE_MIX, "rate": 50.0, "sizes": {"1": 0.8, "8": 0.15, "32": 0.05},
           "check": {"32": 6, "8": 8, "1": 32}}
    reqs = serve.requests(mix, toy.SEED, 30.0, stream=1)
    judged = serve.judged(mix, toy.SEED, reqs)
    sizes = collections.Counter(reqs[i]["n"] for i in judged)
    assert sizes == {32: 6, 8: 8, 1: 32}
    assert judged == serve.judged(mix, toy.SEED, reqs)
