"""The operation and byte counts against hand counts."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from bench_port import flops, roofline
from bench_port.reference.mesh import load_raw
from bench_port.tests import toy


def test_layer_counts_by_hand():
    # K=2 conv, B=2, V=5, 3 -> 4 channels, 7 non-zeros: projections
    # 2 * (2*2*5*3*4) = 480; one apply on min(3, 4) = 3 channels: 2*7*2*3 = 84
    c = flops.Counter.conv(2, 5, 3, 4, 2, 7)
    assert (c.proj, c.apply) == (480, 84)
    assert flops.Counter.dense(3, 10, 2).proj == 120          # 2*3*10*2
    assert flops.Counter.apply(2, 9, 5).apply == 180          # 2*9*2*5
    assert flops.Counter.conv(1, 4, 6, 2, 3, 10).apply == 2 * (2 * 10 * 1 * 2)


def test_backward_counts_the_gradients_a_step_needs():
    layers = [flops.Layer(10.0, 1.0), flops.Layer(20.0, 2.0)]
    # weights of both, inputs of the second only: 10 + 20 + 22
    assert flops.Counter._backward(layers, True, False) == 52.0
    # inputs only (detached weights), the first layer's included: 11 + 22
    assert flops.Counter._backward(layers, False, True) == 33.0


def test_identity_operators_count_nothing():
    raw = {"A": [sp.csr_matrix(np.ones((3, 3)) - np.eye(3))] * 2,
           "D": [sp.identity(3, format="csr")], "U": [sp.identity(3, format="csr")],
           "A_d": [sp.csr_matrix(np.ones((3, 3)) - np.eye(3))] * 2,
           "D_d": [sp.csr_matrix(np.eye(3)[:2] + 0.5 * np.eye(3)[1:])], "edges": np.zeros((4, 2))}
    k = flops.Counter({"num_conv_layers": 4, "nf": 1}, raw)
    assert k.nnz_down == [0] and k.nnz_up == [0]
    assert k.nnz_lap == [6, 6] and k.nnz_down_d == [4]


def test_the_flagship_counts():
    """The published matrices' non-zeros, and the flagship's step counted
    as the sum of its passes."""
    raw = load_raw(toy.REPO + "/assets")
    cf = toy.with_settings(toy.config())
    cf["settings"].update(num_conv_layers=8, nf=64, nz=64, nz_cond=32, nz_cond2=32, reduce_dim=64)
    k = flops.Counter(cf["settings"], raw)
    assert k.sizes == [6890, 6890, 3445, 3445, 1723, 1723, 862, 862, 862]
    assert k.nnz_lap[0] == 41328 and k.n_edges == 20664
    assert k.train_step(32) == pytest.approx(6.087e11, rel=1e-3)
    assert k.decode_call(32) == pytest.approx(8.659e10, rel=1e-3)


def test_apply_bound_by_hand():
    """A band apply: x read once, y written once, each non-zero as its
    value and a 4-byte index; 2 operations per non-zero, sample, channel."""
    blocks = torch.zeros((1, 1, 128, 128))
    blocks[0, 0, :10, :10] = 1.0                               # 100 non-zeros
    b = roofline.apply_bound(blocks, 2, 128, 128, 8, torch.float32)
    assert b["bytes"] == 4 * 2 * 8 * (128 + 128) + 100 * 8
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / roofline.HBM_BYTES_PER_S * 1e3)
    with_addend = roofline.apply_bound(blocks, 2, 128, 128, 8, torch.float32, addend=True)
    assert with_addend["bytes"] == b["bytes"] + 4 * 2 * 8 * 128
