"""Attention with q and k wider than v and the caller's scale (MLA's heads:
q·kᵀ at Dqk 192, p·v at Dv 128, scale 192^-½·mscale²).

The plain versions (``mha_reference``, ``flash_attention_fwd_reference``,
``flash_attention_bwd_reference``) against float64 autograd of the softmax
written out; ``FlashAttention`` on the CPU against them; the wrappers'
checks; and the kernels' CUDA sources at 192/128 in bf16, compiled by g++
against the emulation of ``tests/test_torch_fwd_kernel_emulated.py``
(imported, not copied), against the plain versions with the kernels' own
bf16 tolerances (forward 3e-2, backward 8e-2).
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from dr4sr_tpu_torch.ops import _build, attention
from dr4sr_tpu_torch.ops.attention import (
    FlashAttention,
    flash_attention_bwd_reference,
    flash_attention_fwd_reference,
    mha_reference,
    multihead_attention,
)
from test_torch_fwd_kernel_emulated import _lse_reference, emulated_library

SCALE = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2


def _inputs(b, h, lq, lk, dqk, dv, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
                   for s in ((b, h, lq, dqk), (b, h, lk, dqk), (b, h, lk, dv), (b, h, lq, dv)))
    seqlen = np.array([lk - 3 - 5 * i for i in range(b)])
    pad = torch.from_numpy(np.arange(lk)[None, :] >= seqlen[:, None])
    return q, k, v, do, pad


def _softmax_attention(q, k, v, pad, causal, scale):
    """float64 softmax attention, written out, for autograd."""
    s = q.double() @ k.double().transpose(-1, -2) * scale
    lq, lk = q.shape[2], k.shape[2]
    invalid = pad[:, None, None, :]
    if causal:
        invalid = invalid | (torch.arange(lk)[None, :] > torch.arange(lq)[:, None])
    return torch.softmax(s.masked_fill(invalid, float("-inf")), -1) @ v.double()


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_and_backward_at_dqk_192_dv_128(causal):
    q, k, v, do, pad = _inputs(2, 3, 12, 12, 192, 128, 1)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    want = _softmax_attention(*leaves, pad, causal, SCALE)
    want_grads = torch.autograd.grad(want, leaves, do.double())
    o = mha_reference(q, k, v, pad, causal, SCALE)
    assert o.shape == (2, 3, 12, 128)
    assert (o.double() - want).abs().max() < 1e-5
    o2, lse = flash_attention_fwd_reference(q, k, v, pad, causal, scale=SCALE)
    assert torch.equal(o, o2)
    s = q.double() @ k.double().transpose(-1, -2) * SCALE
    invalid = pad[:, None, None, :] | (torch.triu(torch.ones(12, 12, dtype=torch.bool), 1)
                                       if causal else torch.zeros(12, 12, dtype=torch.bool))
    assert (lse.double() - torch.logsumexp(s.masked_fill(invalid, float("-inf")), -1)
            ).abs().max() < 1e-5
    grads = flash_attention_bwd_reference(q, k, v, o, do, pad, causal, scale=SCALE)
    for g, w, ref in zip(grads, want_grads, (q, k, v)):
        assert g.shape == ref.shape
        assert (g.double() - w).abs().max() < 1e-4 * max(1.0, w.abs().max().item())


def test_default_scale_is_one_over_root_dqk():
    """Without a scale, q·kᵀ takes 1/√Dqk, Dqk being q's head size, also when v
    is narrower; a given scale of that value gives the same bits."""
    q, k, v, _, pad = _inputs(1, 2, 9, 9, 192, 128, 2)
    assert torch.equal(mha_reference(q, k, v, pad, True),
                       mha_reference(q, k, v, pad, True, 1.0 / (192 ** 0.5)))
    want = _softmax_attention(q, k, v, pad, True, 192 ** -0.5)
    assert (mha_reference(q, k, v, pad, True).double() - want).abs().max() < 1e-5


def test_flash_attention_on_the_cpu_takes_the_scale_through_autograd():
    q, k, v, do, pad = _inputs(2, 2, 10, 10, 192, 128, 3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = multihead_attention(*leaves, pad, True, SCALE)
    got = torch.autograd.grad(out, leaves, do)
    fleaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fout = FlashAttention.apply(*fleaves, pad, True, SCALE)
    assert torch.equal(out, fout)
    want = flash_attention_bwd_reference(q, k, v, fout.detach(), do, pad, True, scale=SCALE)
    for g, f, w in zip(got, torch.autograd.grad(fout, fleaves, do), want):
        assert (g - w).abs().max() < 1e-5 and torch.equal(f, w)


def test_the_wrappers_take_only_the_instantiated_pairs():
    """(Dqk, Dv) = (192, 128) in bf16 only; other unequal pairs, or f32 at
    192/128, are refused before any build or launch."""
    for dqk, dv, dtype in ((192, 64, torch.bfloat16), (128, 192, torch.bfloat16),
                           (192, 128, torch.float32)):
        q = _OnCuda(torch.zeros(1, 1, 8, dqk, dtype=dtype))
        v = _OnCuda(torch.zeros(1, 1, 8, dv, dtype=dtype))
        with pytest.raises(ValueError, match="head dims"):
            attention._check_inputs(q, q, v, None, "flash_attention_fwd")
    assert (192, 128) in attention.WIDE_QK_HEAD_DIMS


class _OnCuda:
    """A CPU tensor's shape and dtype under a CUDA device, for the wrappers'
    shape checks (there is no card here)."""

    def __init__(self, t):
        self.device = type("Device", (), {"type": "cuda"})()
        self.dtype, self.shape, self._dim = t.dtype, t.shape, t.dim()

    def dim(self):
        return self._dim


# --- the kernels' CUDA sources at 192/128, on the CPU through the emulation

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    libs = {}
    for name, argtypes in (("fwd", attention._FWD_SCALED_ARGTYPES),
                           ("bwd", attention._BWD_SCALED_ARGTYPES)):
        lib = emulated_library(_build.source_path(f"flash_attention_{name}"),
                               tmp_path_factory.mktemp(f"emulated_{name}"))
        fn = getattr(lib, f"dr4sr_flash_attention_{name}_scaled")
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        libs[name] = fn
    return libs


# (B, H, Lq, Lk, causal): one key tile (the backward's one-launch route) and
# several, ragged; one and several query tiles
MLA_CASES = [(2, 1, 40, 40, True), (1, 2, 70, 70, True), (2, 1, 30, 90, False)]


@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: "x".join(map(str, c)))
def test_emulated_kernels_at_dqk_192_dv_128(emulated, case):
    b, h, lq, lk, causal = case
    q, k, v, do, pad = _inputs(b, h, lq, lk, 192, 128, lq + lk, torch.bfloat16)
    o = torch.full((b, h, lq, 128), float("nan"), dtype=torch.bfloat16)
    lse = torch.full((b, h, lq), float("nan"))
    err = emulated["fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(), o.data_ptr(),
                          lse.data_ptr(), b, h, lq, lk, 192, 128, SCALE, int(causal), 1, None)
    assert err == 0
    want = mha_reference(q, k, v, pad, causal, SCALE)
    assert (o.float() - want.float()).abs().max().item() <= 3e-2
    want_lse = _lse_reference(q.float() * (SCALE * 192 ** 0.5), k.float(), pad, causal)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    scratch = torch.full((b, h, lq), float("nan"))
    launched = emulated["bwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               do.data_ptr(), lse.data_ptr(), pad.data_ptr(), dq.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, h, lq, lk,
                               192, 128, SCALE, int(causal), 1, None)
    assert launched == (1 if lk <= 64 else 2)
    want_grads = flash_attention_bwd_reference(q, k, v, o, do, pad, causal, scale=SCALE)
    for g, w in zip((dq, dk, dv), want_grads):
        assert g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= 8e-2


def test_emulated_kernels_refuse_other_unequal_pairs(emulated):
    q = torch.zeros(1, 1, 8, 192, dtype=torch.bfloat16)
    v = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    o = torch.zeros_like(v)
    assert emulated["fwd"](q.data_ptr(), q.data_ptr(), v.data_ptr(), None, o.data_ptr(), None,
                           1, 1, 8, 8, 192, 64, 0.1, 1, 1, None) != 0
    qf = torch.zeros(1, 1, 8, 192)
    vf, of = torch.zeros(1, 1, 8, 128), torch.zeros(1, 1, 8, 128)
    assert emulated["fwd"](qf.data_ptr(), qf.data_ptr(), vf.data_ptr(), None, of.data_ptr(), None,
                           1, 1, 8, 8, 192, 128, 0.1, 1, 0, None) != 0
