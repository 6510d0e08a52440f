"""The port's attention backward (its plain version, and the autograd wiring
on CPU tensors) against the JAX package's Pallas backward in interpret mode
and ``jax.vjp`` of its ``mha_reference``.

Tolerances:
* plain backward vs the Pallas backward: f32 atol 1e-5 (the same
  arithmetic, sums in another order); bf16 atol 2e-2 (both round p and ds to
  bf16 at the same points; the results differ by the final bf16 rounding);
* either vs ``jax.vjp(mha_reference)`` in f32: 3e-4 in f32 and 8e-2 in bf16,
  the tolerances of tests/test_attention.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.ops.attention import flash_attention_bwd as jax_flash_bwd
from dr4sr_tpu.ops.attention import mha_reference as jax_reference
from dr4sr_tpu_torch.ops.attention import (
    FlashAttention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    mha_reference,
    multihead_attention,
)

# (b, h, lq, lk, dh, causal, seqlens)
CASES = {
    "causal": (2, 2, 50, 50, 32, True, [50, 23]),
    "noncausal": (2, 2, 50, 50, 32, False, [50, 23]),
    "fully_masked_row": (2, 2, 20, 20, 16, True, [0, 11]),
    "cross_lq_ne_lk": (2, 2, 20, 50, 32, False, [50, 9]),
    "dh16": (2, 1, 40, 40, 16, True, [40, 31]),
    "long_several_tiles": (1, 1, 200, 200, 16, True, [200]),
}
PLAIN_VS_PALLAS = {np.float32: 1e-5, "bfloat16": 2e-2}
VS_VJP = {np.float32: 3e-4, "bfloat16": 8e-2}


def _inputs(name, seed=0):
    b, h, lq, lk, dh, causal, seqlens = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, lq, dh)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, dh)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, dh)).astype(np.float32)
    g = rng.normal(size=(b, h, lq, dh)).astype(np.float32)
    mask = np.arange(lk)[None, :] >= np.asarray(seqlens)[:, None]
    return q, k, v, g, mask, causal


def _vjp(q, k, v, g, mask, causal):
    o, vjp = jax.vjp(lambda q_, k_, v_: jax_reference(q_, k_, v_, jnp.asarray(mask), causal),
                     *map(jnp.asarray, (q, k, v)))
    return np.array(o), [np.array(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_pallas_and_vjp(name, dtype):
    q, k, v, g, mask, causal = _inputs(name)
    o, want_vjp = _vjp(q, k, v, g, mask, causal)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want_pallas = jax_flash_bwd(*(jnp.asarray(x).astype(jdt) for x in (q, k, v, o, g)),
                                jnp.asarray(mask), causal=causal, interpret=True)
    got = flash_attention_bwd_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v, o, g)), torch.from_numpy(mask), causal)
    key = np.float32 if dtype == "float32" else "bfloat16"
    for ours, pallas, ref in zip(got, want_pallas, want_vjp):
        assert ours.dtype == tdt
        ours = ours.float().numpy()
        np.testing.assert_allclose(ours, np.asarray(pallas, np.float32), atol=PLAIN_VS_PALLAS[key])
        np.testing.assert_allclose(ours, ref, atol=VS_VJP[key])
        np.testing.assert_allclose(np.asarray(pallas, np.float32), ref, atol=VS_VJP[key])
    fully_masked = np.asarray(CASES[name][6]) == 0
    for ours in got:
        assert (ours[fully_masked] == 0).all()


@pytest.mark.parametrize("name", ["causal", "fully_masked_row", "cross_lq_ne_lk"])
def test_flash_attention_function_matches_autograd(name):
    """FlashAttention's wiring (plain halves on CPU tensors) against autograd
    through mha_reference, with and without a mask."""
    q, k, v, g, mask, causal = _inputs(name, seed=1)
    for tmask in (torch.from_numpy(mask), None):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = FlashAttention.apply(*leaves, tmask, causal)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
        ref_leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        ref_out = mha_reference(*ref_leaves, tmask, causal)
        want = torch.autograd.grad(ref_out, ref_leaves, torch.from_numpy(g))
        np.testing.assert_array_equal(out.detach().numpy(), ref_out.detach().numpy())
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_function_takes_a_transposed_incoming_gradient():
    """The gradient reaching the backward can be a non-contiguous view (the
    encoder reshapes the attention output before out_proj)."""
    q, k, v, g, mask, causal = _inputs("causal", seed=2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = FlashAttention.apply(*leaves, torch.from_numpy(mask), causal)
    w = torch.from_numpy(g).transpose(1, 2).contiguous()  # [B, L, H, Dh]
    (out.transpose(1, 2) * w).sum().backward()
    want = flash_attention_bwd_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                         out.detach(), torch.from_numpy(g),
                                         torch.from_numpy(mask), causal)
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), ref.numpy(), atol=1e-6)


def test_cpu_route_differentiates_through_the_plain_version():
    q, k, v, g, mask, causal = _inputs("noncausal", seed=3)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    multihead_attention(*leaves, torch.from_numpy(mask), causal).backward(torch.from_numpy(g))
    _, want = _vjp(q, k, v, g, mask, causal)
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=3e-4)


def test_backward_kernel_takes_cuda_tensors_only():
    flash_attention_bwd.launches = 0
    q = torch.zeros(1, 1, 4, 32)
    lse = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, q, q, q, q, lse)
    assert flash_attention_bwd.launches == 0
