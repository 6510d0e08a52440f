"""The port's attention (plain version and CPU route) against the JAX package's
``mha_reference`` and its Pallas ``flash_attention`` in interpret mode.

Tolerances: f32 atol 2e-5 (as in tests/test_attention.py: sums run in
another order); bf16 atol 3e-2 (bf16 rounding of the operands and of p).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.ops.attention import flash_attention as jax_flash
from dr4sr_tpu.ops.attention import mha_reference as jax_reference
from dr4sr_tpu_torch.ops.attention import flash_attention_fwd, mha_reference, multihead_attention


def _inputs(seed, b, h, lq, lk, dh, seqlens):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, lq, dh)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, dh)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, dh)).astype(np.float32)
    mask = np.arange(lk)[None, :] >= np.asarray(seqlens)[:, None]
    return q, k, v, mask


# (b, h, lq, lk, dh, causal, seqlens)
CASES = {
    "causal": (2, 2, 50, 50, 32, True, [50, 17]),
    "noncausal": (2, 2, 50, 50, 32, False, [50, 17]),
    "several_key_blocks": (1, 1, 300, 300, 16, True, [300]),
    "cross_lq_ne_lk": (2, 2, 20, 50, 32, False, [50, 9]),
    "all_padded_row": (2, 1, 8, 8, 16, True, [0, 5]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_matches_jax(name):
    b, h, lq, lk, dh, causal, seqlens = CASES[name]
    q, k, v, mask = _inputs(0, b, h, lq, lk, dh, seqlens)
    want = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v, mask)), causal=causal))
    want_flash = np.asarray(
        jax_flash(*map(jnp.asarray, (q, k, v, mask)), causal=causal, interpret=True)
    )
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    flash_attention_fwd.launches = 0
    got = mha_reference(tq, tk, tv, tmask, causal).numpy()
    routed = multihead_attention(tq, tk, tv, tmask, causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, want_flash, atol=2e-5)
    np.testing.assert_array_equal(routed, got)
    assert flash_attention_fwd.launches == 0  # the CPU route never reaches the kernel
    fully_masked = np.asarray(seqlens) == 0
    if fully_masked.any():
        assert (got[fully_masked] == 0.0).all()


def test_bf16_follows_tpu_policy():
    q, k, v, mask = _inputs(1, 2, 2, 50, 50, 32, [50, 23])
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(qb, kb, vb, jnp.asarray(mask), causal=True, interpret=True),
                      np.float32)
    want_f32 = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v, mask)), causal=True))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = multihead_attention(tq, tk, tv, torch.from_numpy(mask), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(), want_f32, atol=3e-2)


def test_kernel_takes_cuda_tensors_only():
    q = torch.zeros(1, 1, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q)
    meta = torch.empty(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="no attention route"):
        multihead_attention(meta, meta, meta)
