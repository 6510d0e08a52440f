"""The yardstick's FLOP and byte counts against shapes worked by hand."""

import numpy as np
import pytest

import arith


def test_unmasked_pairs():
    keys = np.array([[1, 1, 0], [1, 1, 1]], bool)
    # causal over Lq = 3: row 0 sees 1 key each, row 1 sees 2, row 2 sees 2 / 3
    assert arith.unmasked_pairs(keys, 3, True) == (1 + 2 + 2) + (1 + 2 + 3)
    assert arith.unmasked_pairs(keys, 4, False) == 5 * 4


def test_attention_bounds():
    keys = np.ones((1, 64), bool)
    # 1 x 1 x 64 x 64 x 32 f32, no padding, not causal: bytes 2·4·(2048·2) + 64
    nbytes = 2 * 64 * 32 * 4 * 2 + 64
    flops = 4 * 32 * 64 * 64
    assert arith.attention_fwd_bound_s(1, 1, 64, 64, 32, keys, False) == pytest.approx(
        max(nbytes / arith.PEAK_BYTES_PER_S, flops / arith.PEAK_FLOPS_F32))
    nbytes = 4 * 4 * (64 * 32 * 2) + 4 * 64 + 64
    assert arith.attention_bwd_bound_s(1, 1, 64, 64, 32, keys, False) == pytest.approx(
        max(nbytes / arith.PEAK_BYTES_PER_S, 10 * 32 * 64 * 64 / arith.PEAK_FLOPS_F32))


def test_sasrec_flops():
    # one row of 2 real positions, D 4, FFN 8, one layer, one negative
    per_layer = 2 * 2 * (4 * 16 + 2 * 4 * 8) + 4 * 4 * 3  # projections, FFN; 3 causal pairs
    scores = 2 * 2 * 4 * 2
    assert arith.sasrec_step_flops(np.array([2]), 4, 8, 1) == 3 * (per_layer + scores)


def test_regenerator_flops():
    ls, lt = np.array([10, 4]), np.array([5, 3])
    # each vocabulary row costs 3 · 2·D at each real target position
    more = arith.regenerator_step_flops(ls, lt, 64, 256, 2, 5, 101)
    less = arith.regenerator_step_flops(ls, lt, 64, 256, 2, 5, 100)
    assert more - less == 3 * 2 * 64 * (5 + 3)
    # one layer's encoder over 10 source positions, by hand: projections, FFN, 55 causal pairs
    enc = 2 * 10 * (4 * 64 * 64 + 2 * 64 * 256) + 4 * 64 * 55
    one = arith.regenerator_step_flops(np.array([10]), np.array([5]), 64, 256, 1, 5, 100)
    two = arith.regenerator_step_flops(np.array([10]), np.array([5]), 64, 256, 2, 5, 100)
    dec = (2 * 5 * 4 * 64 * 64 + 4 * 64 * 15 + 2 * 5 * 2 * 64 * 64 + 2 * 10 * 2 * 64 * 64
           + 4 * 64 * 5 * 10 + 2 * 5 * 2 * 64 * 256)
    assert two - one == 3 * (enc + dec)
