"""Multi-head attention: the plain PyTorch version and the CUDA kernel's wrapper.

* :func:`mha_reference` — plain PyTorch attention with the semantics of
  ``dr4sr_tpu/ops/attention.py::mha_reference``: key-padding mask (True =
  pad) and an optional causal constraint, -1e30 mask fill, a safe softmax,
  and fully-masked query rows → 0 (PyTorch's SDPA gives NaN there). Scores
  and p·v are f32 with TF32 off.
* :func:`flash_attention` — the hand-written CUDA kernel
  (``csrc/flash_attention_fwd.cu``), which replaces the Pallas TPU kernel
  ``dr4sr_tpu/ops/attention.py::_flash_kernel``. CUDA tensors only.
* :func:`multihead_attention` — the dispatcher: a CPU tensor goes to
  :func:`mha_reference`, a CUDA tensor to the kernel, or the call raises.

Layout is the JAX package's: q [B, H, Lq, Dh], k/v [B, H, Lk, Dh], mask
[B, Lk]. The backward kernel (``_flash_bwd_kernel``) is not ported yet, so
the kernel refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

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
    lq, dh = q.shape[2], q.shape[3]
    lk = k.shape[2]
    scale = 1.0 / (dh**0.5)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # f32 scores: TF32 off
    try:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if causal:
            row = torch.arange(lq, device=q.device)[:, None]
            col = torch.arange(lk, device=q.device)[None, :]
            scores = scores.masked_fill(col > row, _NEG_INF)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
        # safe softmax: fully-masked rows -> zeros
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        e = e.masked_fill(scores <= _NEG_INF / 2, 0.0)
        p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out = torch.matmul(p, v.float())
    finally:
        torch.set_float32_matmul_precision(prev)
    return out.to(q.dtype)


_C_ARGTYPES = (
    [ctypes.c_void_p] * 5  # q, k, v, key_padding_mask, o
    + [ctypes.c_int] * 7  # batch, heads, lq, lk, head_dim, causal, is_bf16
    + [ctypes.c_void_p]  # stream
)


@functools.cache
def _kernel():
    lib = _build.load("flash_attention_fwd")
    fn = lib.dr4sr_flash_attention_fwd
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """The CUDA flash-attention forward. q,k,v: [B, H, L, Dh] contiguous CUDA
    tensors of one dtype (f32 or bf16), Dh in {16, 32, 64, 128}; mask [B, Lk]
    bool (True = pad) or None. Raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
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
            raise ValueError("flash_attention takes contiguous tensors")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward kernel yet; call it under torch.no_grad()"
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_padding_mask is None else key_padding_mask.data_ptr(),
            out.data_ptr(), b, h, lq, lk, dh, int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the last reset


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """CPU tensors → :func:`mha_reference`; CUDA tensors → the kernel."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, key_padding_mask, causal)
    if q.device.type == "cuda":
        return flash_attention(q, k, v, key_padding_mask, causal)
    raise ValueError(f"no attention route for device {q.device}")
