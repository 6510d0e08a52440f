"""Multi-head attention: the plain PyTorch version and the CUDA kernel's wrapper.

* :func:`mha_reference` — plain PyTorch attention with the semantics of
  ``dr4sr_tpu/ops/attention.py::mha_reference``: key-padding mask (True =
  pad) and an optional causal constraint, -1e30 mask fill, a safe softmax,
  and fully-masked query rows → 0 (PyTorch's SDPA gives NaN there). Scores
  and p·v are f32 with TF32 off.
* :func:`flash_attention_fwd_reference` — plain PyTorch with the forward
  kernel's contract: (o, row log-sum-exp), +inf for a fully masked row.
* :func:`flash_attention_bwd_reference` — plain PyTorch of the arithmetic of
  ``dr4sr_tpu/ops/attention.py::_flash_bwd_kernel``, its rounding points
  included: dq, dk, dv from q, k, v, o, dO and the mask; given the row
  log-sum-exp, p = exp(s − lse) as the backward kernel takes it, so a block
  of the key axis gets its share of the whole row's softmax (the ring's
  blocks, ``ops/ring_attention.py``).
* :func:`flash_attention_fwd` — the hand-written CUDA forward kernel
  (``csrc/flash_attention_fwd.cu``), which replaces the Pallas TPU kernel
  ``_flash_kernel``: q·kᵀ and p·v on tensor cores (``mma.sync``), bf16
  operands for bf16 inputs and split TF32 (3xTF32, f32-accurate) for f32
  inputs, with the softmax statistics in f32; no autograd, and it can also
  return the row log-sum-exp. CUDA tensors only, contiguous and 16-byte
  aligned (the kernel copies 16-byte chunks with ``cp.async``).
* :func:`flash_attention_bwd` — the hand-written CUDA backward
  (``csrc/flash_attention_bwd.cu``), which replaces ``_flash_bwd_kernel``:
  the five products on tensor cores in one pass over the keys, one launch
  when the key axis fits one 64-key tile (the train path). CUDA tensors
  only.
* :class:`FlashAttention` — the ``autograd.Function`` tying the two, as
  ``_flash_diff`` ties the Pallas kernels: it saves q, k, v, o, the mask and
  the forward's row log-sum-exp (no [B, H, L, L] residual). CPU tensors take
  the plain halves, CUDA tensors the kernels. Its backward is once
  differentiable: a backward with ``create_graph=True`` (for a second
  derivative, a Hessian-vector product) raises, where it would otherwise
  take the kernels' gradients as constants.
* :func:`multihead_attention` — the dispatcher: under a context-parallel
  plan the ring of ``ops/ring_attention.py``; else a CPU tensor goes to
  :func:`mha_reference` (plain autograd), a CUDA tensor to
  :class:`FlashAttention`, or the call raises.
* :func:`plain_attention` — a scoped context inside which a CUDA tensor also
  goes to :func:`mha_reference`, whose autograd differentiates twice: the
  bilevel trainer's outer step enters it, as the JAX package's enters
  ``reference_attention()``.

Layout is the JAX package's: q [B, H, Lq, Dh], k/v [B, H, Lk, Dh], mask
[B, Lk].
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
from typing import Optional, Tuple

import torch

from dr4sr_tpu_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Plain attention. q,k,v: [B, H, L, Dh]; key_padding_mask: [B, Lk] True=pad."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # f32 scores: TF32 off
    try:
        p = _probs(*_masked_scores(q, k, key_padding_mask, causal))
        out = torch.matmul(p, v.float())
    finally:
        torch.set_float32_matmul_precision(prev)
    return out.to(q.dtype)


def _masked_scores(
    q: torch.Tensor, k: torch.Tensor, key_padding_mask: Optional[torch.Tensor], causal: bool
):
    """f32 scores q·kᵀ/√Dh with the masks at -1e30, and the mask itself."""
    lq, dh = q.shape[2], q.shape[3]
    lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / (dh**0.5))
    invalid = torch.zeros(1, 1, lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        row = torch.arange(lq, device=q.device)[:, None]
        col = torch.arange(lk, device=q.device)[None, :]
        invalid = invalid | (col > row)
    if key_padding_mask is not None:
        invalid = invalid | key_padding_mask[:, None, None, :]
    return s.masked_fill(invalid, _NEG_INF), invalid


def _probs(s: torch.Tensor, invalid: torch.Tensor) -> torch.Tensor:
    """Safe softmax over the key axis: masked entries are 0 after the exp,
    so a fully masked row is 0 (PyTorch's SDPA gives NaN there)."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach()).masked_fill(invalid, 0.0)
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) as :func:`flash_attention_fwd` with ``want_lse`` returns
    them: o as :func:`mha_reference`, lse [B, H, Lq] f32 the log-sum-exp of
    the row's unmasked scaled scores, +inf on a fully masked row. No
    autograd."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # f32 scores: TF32 off
    try:
        with torch.no_grad():
            s, invalid = _masked_scores(q, k, key_padding_mask, causal)
            o = torch.matmul(_probs(s, invalid), v.float())
            m = s.amax(dim=-1)
            l = torch.exp(s - m[..., None]).masked_fill(invalid, 0.0).sum(dim=-1)
            lse = torch.where(l > 0, m + torch.log(l), torch.inf)
    finally:
        torch.set_float32_matmul_precision(prev)
    return o.to(q.dtype), lse


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) as the TPU kernel computes them (``attention.py:221-296``):
    p over the full masked key row with masked entries forced to 0 after the
    exp (a fully masked row gives p = 0); dv = pᵀ·dO; ds = p ⊙ (dO·vᵀ −
    rowsum(dO ⊙ o)) with the rowsum in f32; dq = ds·k·scale, dk = dsᵀ·q·scale.
    bf16 inputs: bf16 operand values, p and ds rounded to bf16 before their
    products, f32 accumulation. Results in the input dtype.

    ``lse`` [B, H, Lq] f32 (the forward's row log-sum-exp, possibly over
    more keys than ``k`` holds) gives p = exp(s − lse), as the backward
    kernel takes it, in place of the softmax over ``k``'s keys; +inf gives
    p = 0."""
    bf16 = q.dtype == torch.bfloat16
    scale = 1.0 / (q.shape[3] ** 0.5)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # f32 products: TF32 off
    try:
        s, invalid = _masked_scores(q, k, key_padding_mask, causal)
        if lse is None:
            p = _probs(s, invalid)
        else:
            p = torch.exp(s - lse[..., None]).masked_fill(invalid, 0.0)
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        pm = p.bfloat16().float() if bf16 else p
        dv = torch.matmul(pm.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        d_row = (dof * o.float()).sum(dim=-1, keepdim=True)
        ds = p * (dp - d_row)
        dsm = ds.bfloat16().float() if bf16 else ds
        dq = torch.matmul(dsm, kf) * scale
        dk = torch.matmul(dsm.transpose(-1, -2), qf) * scale
    finally:
        torch.set_float32_matmul_precision(prev)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 6  # q, k, v, key_padding_mask, o, lse
    + [ctypes.c_int] * 7  # batch, heads, lq, lk, head_dim, causal, is_bf16
    + [ctypes.c_void_p]  # stream
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 11  # q, k, v, o, dout, lse, key_padding_mask, dq, dk, dv, scratch
    + [ctypes.c_int] * 7  # batch, heads, lq, lk, head_dim, causal, is_bf16
    + [ctypes.c_void_p]  # stream
)


@functools.cache
def _entry(name: str, argtypes: tuple):
    fn = getattr(_build.load(name), "dr4sr_" + name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k, v, key_padding_mask, name):
    """Validate what the kernels take; return (b, h, lq, lk, dh)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, Dh]")
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, dh) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    tensors = [q, k, v]
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool or key_padding_mask.shape != (b, lk):
            raise ValueError(f"key_padding_mask must be bool [{b}, {lk}]")
        tensors.append(key_padding_mask)
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
        if t is not key_padding_mask and t.dtype != q.dtype:
            raise TypeError("q, k, v must share a dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    _check_aligned((q, k, v), name)
    return b, h, lq, lk, dh


def _check_aligned(tensors, name):
    """The kernels copy q, k, v in 16-byte chunks: each must start on a
    16-byte boundary (a view at an offset may not)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} takes 16-byte aligned tensors, got a data pointer at "
                             f"{t.data_ptr() % 16} bytes past a boundary")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    want_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel, without autograd: (o, lse), lse [B, H, Lq]
    f32 (the row log-sum-exp, +inf on a fully masked row) or None. q,k,v:
    [B, H, L, Dh] contiguous CUDA tensors of one dtype (f32 or bf16), Dh in
    {16, 32, 64, 128}; mask [B, Lk] bool (True = pad) or None. Raises on
    anything else."""
    b, h, lq, lk, dh = _check_inputs(q, k, v, key_padding_mask, "flash_attention_fwd")
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device) if want_lse else None
    if out.numel() == 0:
        return out, lse
    fn = _entry("flash_attention_fwd", tuple(_FWD_ARGTYPES))
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask), out.data_ptr(),
            _ptr(lse), b, h, lq, lk, dh, int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError_t {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0  # forward kernel launches since the last reset


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA flash-attention backward: (dq, dk, dv) in the input dtype.
    q, k, v as for :func:`flash_attention_fwd`; o and do [B, H, Lq, Dh] of q's
    dtype; lse [B, H, Lq] f32 from the forward. All contiguous CUDA
    tensors. One launch when Lk ≤ 64, two otherwise; raises on anything it
    does not take."""
    b, h, lq, lk, dh = _check_inputs(q, k, v, key_padding_mask, "flash_attention_bwd")
    for name, t, shape, dtype in (("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (b, h, lq), torch.float32)):
        if t.shape != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("flash_attention_bwd takes contiguous tensors")
    _check_aligned((o, do), "flash_attention_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 and dk.numel() == 0:
        return dq, dk, dv
    # D = rowsum(dO ⊙ o) when the key axis is more than one tile
    scratch = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    fn = _entry("flash_attention_bwd", tuple(_BWD_ARGTYPES))
    with torch.cuda.device(q.device):
        launched = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), _ptr(key_padding_mask), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), b, h, lq, lk, dh, int(causal),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if launched < 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError_t {-launched}")
    flash_attention_bwd.launches += launched
    return dq, dk, dv


flash_attention_bwd.launches = 0  # CUDA kernel launches since the last reset


class FlashAttention(torch.autograd.Function):
    """Differentiable fused attention, mirroring ``_flash_diff``: the forward
    kernel, then the backward kernels. It saves q, k, v, o, the mask and the
    row log-sum-exp. CPU tensors take the plain halves (:func:`mha_reference`,
    :func:`flash_attention_bwd_reference`). No gradient for the mask."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, causal):
        ctx.causal = causal
        if q.device.type == "cpu":
            o, lse = mha_reference(q, k, v, key_padding_mask, causal), None
        else:
            o, lse = flash_attention_fwd(q, k, v, key_padding_mask, causal,
                                         want_lse=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, o, key_padding_mask, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        # the kernels' gradients have no autograd graph: a backward that
        # builds one (create_graph=True, for a second derivative) would take
        # them as constants and drop attention's second-order terms. So it
        # raises. (``once_differentiable`` would not: the engine prunes its
        # error node from a Hessian-vector product, whose inputs it does not
        # reach, and the terms vanish silently.)
        if torch.is_grad_enabled():
            raise RuntimeError(
                "FlashAttention's backward is once differentiable: a second derivative "
                "(create_graph=True) must run attention inside "
                "dr4sr_tpu_torch.ops.attention.plain_attention()")
        q, k, v, o, key_padding_mask, lse = ctx.saved_tensors
        # the incoming gradient may be a transposed view (layers.py reshapes
        # the output before out_proj) or, under autocast, another dtype
        do = do.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            grads = flash_attention_bwd_reference(q, k, v, o, do, key_padding_mask, ctx.causal)
        else:
            grads = flash_attention_bwd(q, k, v, o, do, lse, key_padding_mask, ctx.causal)
        return (*grads, None, None)


_PLAIN = contextvars.ContextVar("dr4sr_torch_plain_attention", default=False)


@contextlib.contextmanager
def plain_attention():
    """Inside this context :func:`multihead_attention` sends CUDA tensors to
    :func:`mha_reference` too, so that second derivatives (the
    hypergradient's Hessian-vector products) run through plain autograd.
    The routing before the context is restored on exit, also after an
    exception."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """With a context-parallel plan installed
    (``ring_attention.set_context_plan``) and Lq = Lk divisible by its axis
    size: the ring (``ops/ring_attention.py``), through the kernels on the
    card and their plain forms on the CPU. Otherwise CPU tensors, and any
    tensor inside :func:`plain_attention` → :func:`mha_reference`; CUDA
    tensors → the kernels."""
    from dr4sr_tpu_torch.ops import ring_attention

    axis = ring_attention.get_context_plan()
    if (axis is not None and axis.size > 1 and q.shape[2] == k.shape[2]
            and q.shape[2] % axis.size == 0):
        return ring_attention.ring_attention(q, k, v, key_padding_mask, causal, axis=axis)
    if q.device.type == "cpu" or _PLAIN.get():
        return mha_reference(q, k, v, key_padding_mask, causal)
    if q.device.type == "cuda":
        return FlashAttention.apply(q, k, v, key_padding_mask, causal)
    raise ValueError(f"no attention route for device {q.device}")
