"""Ring attention: context-parallel attention over a mesh axis, through the kernels.

Port of ``dr4sr_tpu/ops/ring_attention.py``. The sequence splits into n
chunks of L/n over the axis (the ``model`` axis, ``model.context_parallel =
n``). Rank r keeps its query chunk; the K/V chunks and their padding masks
travel around the ring by point-to-point sends (``collectives.
ring_exchange``; no all-gather of K or V), and each visiting block is
folded into the rank's output:

* one fold is what the forward kernel computes for that block with its row
  log-sum-exp (``flash_attention_fwd(..., want_lse=True)``): causal on the
  rank's own block, non-causal on an earlier block, and no launch for a
  later block under ``causal``;
* the partial outputs merge by their LSEs (:func:`_merge`). The kernel
  writes +inf as the LSE of a fully masked row; the merge gives that
  block weight 0, and a row masked in every block keeps LSE +inf, so its
  output and its gradients are 0;
* the full output is the all-gather of the chunks, in rank order.

The backward takes the rank's chunk of dO and calls the backward kernel
per block with the *global* output chunk and LSE: p = exp(s − lse) and D =
rowsum(dO ⊙ o) are then the whole row's, and the block's dq, dk, dv are its
exact share. dK and dV accumulate in f32 as they travel with their blocks,
and a last send returns them to their owner. Then dq, dk and dv are
all-gathered, so every rank of the axis holds the same full gradients, and
the layers around attention (replicated over the axis) take identical
gradients on every rank.

:class:`RingAttention` takes the full q, k, v [B, H, L, Dh] (replicated over
the axis) and returns the full o. CPU tensors take the kernels' plain forms
(``flash_attention_fwd_reference``, ``flash_attention_bwd_reference`` with
``lse``), so the CPU tests run the ring's exact structure. Its backward is
once differentiable (as ``FlashAttention``'s): DR4SR+'s outer step, which
needs second derivatives, refuses context parallelism.

Reference: Liu et al., "Ring Attention with Blockwise Transformers" (2023).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from dr4sr_tpu_torch.ops.attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from dr4sr_tpu_torch.parallel.collectives import Axis, all_gather, ring_exchange

# The context-parallel plan: the axis encoder attention rings over, installed
# by the trainer around its steps (``model.context_parallel > 1``) and read by
# ``attention.multihead_attention``, as the JAX package's trace-time plan.
_CTX_AXIS: Optional[Axis] = None


def set_context_plan(plan, axis_name: str = "model") -> None:
    """Install the ring over ``plan``'s axis ``axis_name`` (a ``MeshPlan``),
    or clear it with None."""
    global _CTX_AXIS
    _CTX_AXIS = None if plan is None else plan.axis(axis_name)


def get_context_plan() -> Optional[Axis]:
    return _CTX_AXIS


@contextlib.contextmanager
def context_plan(plan, axis_name: str = "model"):
    """The ring over ``plan``'s axis installed for the body (None: no ring);
    the previous plan restored after."""
    global _CTX_AXIS
    prev = _CTX_AXIS
    set_context_plan(plan, axis_name)
    try:
        yield
    finally:
        _CTX_AXIS = prev


def _fwd(q, k, v, pad, causal):
    """(o, lse) of one block: the kernel on the card, its plain form on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, pad, causal)
    return flash_attention_fwd(q, k, v, pad, causal, want_lse=True)


def _bwd(q, k, v, o, do, lse, pad, causal):
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, do, pad, causal, lse=lse)
    return flash_attention_bwd(q, k, v, o, do, lse, pad, causal)


def _merge(o_acc, lw_acc, o_blk, lse_blk):
    """Fold a block's (o, lse) into the running (o f32, log-weight); a row's
    log-weight is its LSE, or -inf where it has seen no key yet."""
    lw_blk = torch.where(torch.isinf(lse_blk), -torch.inf, lse_blk)
    if o_acc is None:
        return o_blk.float(), lw_blk
    m = torch.maximum(lw_acc, lw_blk)
    m = torch.where(torch.isinf(m), 0.0, m)  # both empty: weights exp(-inf) = 0
    w_acc, w_blk = torch.exp(lw_acc - m), torch.exp(lw_blk - m)
    total = w_acc + w_blk
    o = (o_acc * w_acc[..., None] + o_blk.float() * w_blk[..., None]) / total.clamp_min(
        1e-30)[..., None]
    return o, m + torch.log(total)


def _visits(causal: bool, src: int, own: int) -> bool:
    """Whether the block of rank ``src`` is folded into rank ``own``'s queries."""
    return not causal or src <= own


class RingAttention(torch.autograd.Function):
    """The ring over ``axis``; see the module docstring. No gradient for the
    mask."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, causal, axis):
        n, r = axis.size, axis.index
        b, _, length, _ = q.shape
        if key_padding_mask is None:
            key_padding_mask = torch.zeros(b, length, dtype=torch.bool, device=q.device)
        qc = axis.chunk(q, 2).contiguous()
        k_cur, v_cur = axis.chunk(k, 2).contiguous(), axis.chunk(v, 2).contiguous()
        pad_cur = axis.chunk(key_padding_mask, 1).contiguous()
        o_acc = lw = None
        src = r
        for step in range(n):
            if _visits(causal, src, r):
                o_blk, lse_blk = _fwd(qc, k_cur, v_cur, pad_cur, causal and src == r)
                o_acc, lw = _merge(o_acc, lw, o_blk, lse_blk)
            if step + 1 < n:
                k_cur, v_cur, pad_u8 = ring_exchange([k_cur, v_cur, pad_cur.view(torch.uint8)],
                                                     axis)
                pad_cur = pad_u8.view(torch.bool)
                src = (src - 1) % n
        oc = o_acc.to(q.dtype)
        lse = torch.where(torch.isinf(lw), torch.inf, lw)  # a row with no key: +inf
        ctx.causal, ctx.axis = causal, axis
        ctx.save_for_backward(qc, axis.chunk(k, 2).contiguous(),
                              axis.chunk(v, 2).contiguous(),
                              axis.chunk(key_padding_mask, 1).contiguous(), oc, lse)
        return all_gather(oc, axis, dim=2)

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "RingAttention's backward is once differentiable: a second derivative "
                "(create_graph=True) cannot run through context-parallel attention")
        qc, k_cur, v_cur, pad_cur, oc, lse = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        n, r = axis.size, axis.index
        doc = axis.chunk(do, 2).to(qc.dtype).contiguous()
        dq = torch.zeros(qc.shape, dtype=torch.float32, device=qc.device)
        dk = torch.zeros(k_cur.shape, dtype=torch.float32, device=qc.device)
        dv = torch.zeros_like(dk)
        src = r
        for step in range(n):
            if _visits(causal, src, r):
                dq_b, dk_b, dv_b = _bwd(qc, k_cur, v_cur, oc, doc, lse, pad_cur,
                                        causal and src == r)
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            if step + 1 < n:
                k_cur, v_cur, pad_u8, dk, dv = ring_exchange(
                    [k_cur, v_cur, pad_cur.view(torch.uint8), dk, dv], axis)
                pad_cur = pad_u8.view(torch.bool)
                src = (src - 1) % n
        # this rank now holds block r + 1's dK and dV: the next rank owns them
        dk, dv = ring_exchange([dk, dv], axis)
        dtype = qc.dtype
        return (all_gather(dq.to(dtype), axis, 2), all_gather(dk.to(dtype), axis, 2),
                all_gather(dv.to(dtype), axis, 2), None, None, None)


def ring_attention(
    q: torch.Tensor,  # [B, H, L, Dh], replicated over the axis
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, L] True = pad
    causal: bool = True,
    *,
    axis: Axis,
) -> torch.Tensor:
    """Context-parallel attention over ``axis``: the full o [B, H, L, Dh] on
    every rank of it. L must be divisible by the axis size."""
    length = q.shape[2]
    if k.shape[2] != length or length % axis.size:
        raise ValueError(f"the ring needs Lq = Lk divisible by {axis.size}, got "
                         f"{length} and {k.shape[2]}")
    return RingAttention.apply(q, k, v, key_padding_mask, causal, axis)
