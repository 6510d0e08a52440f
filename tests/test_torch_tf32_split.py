"""The f32 route of the forward kernel (``csrc/flash_attention_fwd.cu``)
runs its products on tensor cores in split TF32 ("3xTF32"): each f32 operand
x becomes big = tf32(x) and small = tf32(x − big), and a·b ≈ big·big +
big·small + small·big, with f32 accumulation. Here that arithmetic is
emulated with numpy, the kernel's online softmax over key tiles included, and
held against attention in float64:

* 3xTF32 is within the f32 tolerance (atol 2e-5, as ``chip_smoke.py`` and
  tests/test_attention.py hold the kernel) at every head dim;
* a single TF32 pass is not: it keeps about three decimal digits, which is
  why the kernel never takes that route for f32 inputs.

The float64 reference is tied to the port's ``mha_reference`` here too; that
one's parity with the JAX package is held by tests/test_torch_attention.py.
"""

import numpy as np
import pytest
import torch

from dr4sr_tpu_torch.ops.attention import mha_reference

ATOL_F32 = 2e-5
NEG_INF = np.float32(-1e30)


def tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 of f32's 23 mantissa bits, rounding to
    nearest with ties away from zero (the carry may reach the exponent)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def matmul_3xtf32(a, b):
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    # products of TF32 values are exact in f32; the sums run in f32, the
    # small terms first, as the kernel accumulates them
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def matmul_tf32(a, b):
    return tf32(a) @ tf32(b)


def kernel_f32_route(q, k, v, pad, causal, matmul):
    """The kernel's f32 forward for [B, H, L, Dh] inputs: q pre-scaled in f32,
    an online softmax in f32 over key tiles of 32 at every head dim, masked
    scores -1e30 and masked p 0 after the exp, acc / max(l, 1e-30)."""
    lq, dh = q.shape[2], q.shape[3]
    lk = k.shape[2]
    block_k = 32
    scale = np.float32(1.0 / np.sqrt(np.float64(dh)))
    qs = q * scale
    m = np.full(q.shape[:3] + (1,), NEG_INF, np.float32)
    l = np.zeros(q.shape[:3] + (1,), np.float32)
    acc = np.zeros(q.shape, np.float32)
    rows = np.arange(lq)[:, None]
    for k0 in range(0, lk, block_k):
        kt, vt = k[:, :, k0 : k0 + block_k], v[:, :, k0 : k0 + block_k]
        cols = np.arange(k0, k0 + kt.shape[2])[None, :]
        invalid = pad[:, None, None, k0 : k0 + block_k] | (causal & (cols > rows))[None, None]
        s = np.where(invalid, NEG_INF, matmul(qs, kt.transpose(0, 1, 3, 2)))
        m_new = np.maximum(m, s.max(axis=-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.where(invalid, np.float32(0), np.exp(s - m_new))
        l = l * alpha + p.sum(axis=-1, keepdims=True, dtype=np.float32)
        acc = acc * alpha + matmul(p, vt)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))


def reference_f64(q, k, v, pad, causal):
    """Masked softmax attention in float64; a fully masked row gives 0."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
    s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(dh)
    invalid = pad[:, None, None, :] | (causal & (np.arange(lk)[None, :] > np.arange(lq)[:, None]))
    s = np.where(invalid, -np.inf, s)
    mx = s.max(axis=-1, keepdims=True)
    e = np.where(invalid, 0.0, np.exp(s - np.where(np.isfinite(mx), mx, 0.0)))
    return e @ v / np.maximum(e.sum(axis=-1, keepdims=True), 1e-300)


def _inputs(dh, b=3, h=2, length=100, seed=0):
    """Unit normals (as ``chip_smoke.py`` draws them); batch row 0 is fully
    masked, row 1 unmasked, row 2 padded after 37 keys; causal."""
    rng = np.random.default_rng(seed + dh)
    q, k, v = (rng.standard_normal((b, h, length, dh)).astype(np.float32) for _ in range(3))
    pad = np.arange(length)[None, :] >= np.array([0, length, 37])[:, None]
    return q, k, v, pad


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_3xtf32_holds_the_f32_tolerance(dh):
    q, k, v, pad = _inputs(dh)
    got = kernel_f32_route(q, k, v, pad, True, matmul_3xtf32)
    want = reference_f64(q, k, v, pad, True)
    assert np.abs(got - want).max() <= ATOL_F32
    assert (got[0] == 0).all()  # the fully masked batch row is exactly 0
    port = mha_reference(*map(torch.from_numpy, (q, k, v, pad)), causal=True).numpy()
    assert np.abs(port - want).max() <= ATOL_F32


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_one_tf32_pass_breaks_the_f32_tolerance(dh):
    q, k, v, pad = _inputs(dh)
    got = kernel_f32_route(q, k, v, pad, True, matmul_tf32)
    err = np.abs(got - reference_f64(q, k, v, pad, True)).max()
    assert err > ATOL_F32
    assert err > 10 * np.abs(kernel_f32_route(q, k, v, pad, True, matmul_3xtf32)
                             - reference_f64(q, k, v, pad, True)).max()


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0**-10  # TF32's unit in the last place at 1
    x = np.array([1 + one_ulp / 2,                # a tie: away from zero (RNE would keep 1)
                  -(1 + one_ulp / 2),             # the same below zero
                  1 + one_ulp / 2 - 2.0**-23,     # just below the tie: down
                  1 + 1.5 * one_ulp,              # a tie after an odd last bit: up
                  2 - one_ulp / 2],               # the carry reaches the exponent
                 np.float32)
    want = np.array([1 + one_ulp, -(1 + one_ulp), 1, 1 + 2 * one_ulp, 2], np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    assert not (tf32(np.random.default_rng(0).standard_normal(1000)).view(np.uint32)
                & 0x1FFF).any()
