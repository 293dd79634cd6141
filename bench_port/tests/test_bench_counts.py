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


def _small(**family) -> flops.Counter:
    """A toy counter: 3 vertices a level, a Laplacian of 6
    non-zeros, pools of 9; nf 4 (F = [4, 8, 8, 4]), 3 data and 3
    condition channels, K = 2."""
    a = sp.csr_matrix(np.ones((3, 3)) - np.eye(3))
    pool = sp.csr_matrix(np.full((3, 3), 0.5))
    raw = {"A": [a] * 5, "D": [pool] * 4, "U": [pool] * 4, "A_d": [a] * 2, "D_d": [pool],
           "edges": np.zeros((4, 2))}
    s = {"num_conv_layers": 4, "nf": 4, "nn_input_channel": 3, "nz_cond": 2, "nz_cond2": 1,
         "K": 2, "Kd": 2, "reduce_dim": 2, "nz": 2, "cond_dim": 4, "cond2_dim": 2, "affine": 1,
         **family}
    return flops.Counter(s, raw)


def test_residual_block_by_hand():
    """Block 0 of a conditioned residual encoder at B=2, V=3, 6 -> 4:
    conv1 projections 2 * (2*2*3*6*4) = 576, one apply on min(6, 4):
    2*6*2*4 = 96; conv2 (4 -> 4) 2 * (2*2*3*4*4) = 384 and 96; the skip's
    1x1 projection 2*6*6*4 = 288; the pool 2*9*2*4 = 144. Block 2 (8 ->
    8) has an identity skip: no projection."""
    k = _small(use_res_block=1, cond_encoder=1)
    enc = k.encoder(2)
    assert enc[:4] == [flops.Layer(576, 96, data_in=True), flops.Layer(384, 96),
                       flops.Layer(288, 0, data_in=True), flops.Layer(0, 144)]
    assert enc[4:8] == [flops.Layer(768, 96), flops.Layer(1536, 192), flops.Layer(384),
                        flops.Layer(0, 288)]
    assert enc[8:11] == [flops.Layer(1536, 192), flops.Layer(1536, 192), flops.Layer(0, 288)]
    # weights of the block, inputs of conv2 and the pool (conv1 and the
    # projection read the data): 576+384+288 + 480+144
    assert flops.Counter._backward(enc[:4], True, False) == 1872.0
    # the condition channels' input gradient through conv1 (3 -> 4:
    # 2 * (2*2*3*3*4) = 288, apply 2*6*2*3 = 72) and the projection (144)
    assert k.encoder_cond_grad(2) == [flops.Layer(288, 72), flops.Layer(144)]


def test_conditioned_first_layer_by_hand():
    """A plain encoder with conditions: layer 0 reads 3 + 3 channels
    (576 + 96, as above), and the conditions' input gradient is the conv's
    on their 3 channels; without conditions layer 0 reads 3 channels and
    no input gradient is counted."""
    k = _small(use_res_block=0, cond_encoder=1)
    assert k.encoder(2)[:2] == [flops.Layer(576, 96, data_in=True), flops.Layer(0, 144)]
    assert k.encoder_cond_grad(2) == [flops.Layer(288, 72)]
    bare = _small(use_res_block=0, cond_encoder=0)
    assert bare.encoder(2)[0] == flops.Layer(288, 72, data_in=True)
    assert bare.encoder_cond_grad(2) == []
    # the step's count differs from the bare one by the wider layer 0
    # forward and weight gradient (288 + 24 + 288) and the conditions'
    # input gradient (360)
    assert k.train_step(2) - bare.train_step(2) == 288 + 24 + 288 + 360
