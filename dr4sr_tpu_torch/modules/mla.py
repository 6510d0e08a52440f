"""DeepSeek-V2's attention block: RMSNorm, a SwiGLU MLP, YaRN rotary
positions and multi-head latent attention (MLA), as arXiv:2405.04434 §2 and
the DeepSeek-V2-Lite config (``q_lora_rank`` null) define them.

* :class:`RMSNorm` — x·rsqrt(mean(x²) + eps) in f32, rounded back to the
  input's dtype, times the weight (DeepSeek's ``DeepseekV2RMSNorm``).
* :class:`SwiGLU` — down(silu(gate(x)) ⊙ up(x)), no biases: the dense MLP
  of layer 0 and, at twice the expert width, the shared experts.
* :func:`yarn_inv_freq`, :func:`yarn_mscale` — YaRN's inverse frequencies
  (θ, factor, original length, β_fast, β_slow: DeepSeek's
  ``DeepseekV2YarnRotaryEmbedding``) and its attention scale factor
  0.1·mscale·ln(factor) + 1. The cos/sin tables are scaled by
  mscale(factor, mscale)/mscale(factor, mscale_all_dim), which is 1 here.
* :func:`rotate_pairs` — the rotation of pairs (2i, 2i+1) by frequency i.
  DeepSeek's code first moves the even elements before the odd ones and
  then rotates halves; that permutes q_pe and k_pe alike and leaves every
  q·k unchanged, so the pairs stay where they are here.
* :class:`MLA` — q = W_q·h per head [q_nope 128 | q_pe 64]; W_kva·h =
  [c_kv 512 | k_pe 64], k_pe one vector shared by the heads; RMSNorm(c_kv)
  → W_kvb → [k_nope 128 | v 128] per head; q_pe and k_pe rotated; scores
  at Dqk 192 with the scale Dqk^-½·mscale², p·v at Dv 128; W_o back to the
  hidden size. Attention goes through ``ops.attention.multihead_attention``
  (the CUDA kernels at Dqk 192 / Dv 128 in bf16 on the card), causal with
  the key-padding mask.

Weights are normal(0.02) drawn from the caller's generator in the order the
modules declare them; norms start at 1.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dr4sr_tpu_torch.modules.layers import normal_
from dr4sr_tpu_torch.ops.attention import multihead_attention


def weight(d_out: int, d_in: int, generator: Optional[torch.Generator], *lead: int):
    """A bias-free projection's weight [*lead, d_out, d_in], normal(0.02)."""
    w = nn.Parameter(torch.empty(*lead, d_out, d_in))
    normal_(w, generator)
    return w


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * y.to(x.dtype)


class SwiGLU(nn.Module):
    def __init__(self, hidden: int, width: int, generator: Optional[torch.Generator]) -> None:
        super().__init__()
        self.w_gate = weight(width, hidden, generator)
        self.w_up = weight(width, hidden, generator)
        self.w_down = weight(hidden, width, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(F.silu(F.linear(x, self.w_gate)) * F.linear(x, self.w_up), self.w_down)


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(dim: int, base: float, factor: float, original_max_pos: int,
                  beta_fast: float, beta_slow: float) -> torch.Tensor:
    """[dim / 2] f32: the extrapolated frequencies θ^(-2i/dim) below the
    correction range, the interpolated ones (over ``factor``) above it, and
    a linear ramp between."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** exponents)
    freq_inter = 1.0 / (factor * base ** exponents)
    low = max(math.floor(_correction_dim(beta_fast, dim, base, original_max_pos)), 0)
    high = min(math.ceil(_correction_dim(beta_slow, dim, base, original_max_pos)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    extra = 1.0 - ramp
    return freq_inter * (1 - extra) + freq_extra * extra


def rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., L, heads, dim] rotated in f32: pair (2i, 2i+1) of position p by
    angle p·inv_freq[i]; cos, sin [L, dim / 2]."""
    xf = x.float()
    even, odd = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack((even * c - odd * s, even * s + odd * c), dim=-1).flatten(-2)


class MLA(nn.Module):
    def __init__(self, hidden: int, heads: int, qk_nope: int, qk_rope: int, v_head: int,
                 kv_lora: int, eps: float, rope: dict, generator: Optional[torch.Generator]):
        super().__init__()
        self.heads, self.qk_nope, self.qk_rope, self.v_head = heads, qk_nope, qk_rope, v_head
        self.kv_lora = kv_lora
        self.w_q = weight(heads * (qk_nope + qk_rope), hidden, generator)
        self.w_kva = weight(kv_lora + qk_rope, hidden, generator)
        self.kv_norm = RMSNorm(kv_lora, eps)
        self.w_kvb = weight(heads * (qk_nope + v_head), kv_lora, generator)
        self.w_o = weight(hidden, heads * v_head, generator)
        factor = float(rope["factor"])
        self.register_buffer("inv_freq", yarn_inv_freq(
            qk_rope, float(rope["theta"]), factor, int(rope["original_max_position_embeddings"]),
            float(rope["beta_fast"]), float(rope["beta_slow"])), persistent=False)
        self.rope_mscale = (yarn_mscale(factor, float(rope["mscale"]))
                            / yarn_mscale(factor, float(rope["mscale_all_dim"])))
        self.softmax_scale = ((qk_nope + qk_rope) ** -0.5
                              * yarn_mscale(factor, float(rope["mscale_all_dim"])) ** 2)

    def rope_tables(self, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.arange(length, dtype=torch.float32, device=self.inv_freq.device)
        freqs = torch.outer(t, self.inv_freq)
        return freqs.cos() * self.rope_mscale, freqs.sin() * self.rope_mscale

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, l, _ = x.shape
        h, nope, rope, dv = self.heads, self.qk_nope, self.qk_rope, self.v_head
        q_nope, q_pe = F.linear(x, self.w_q).view(b, l, h, nope + rope).split([nope, rope], -1)
        c_kv, k_pe = F.linear(x, self.w_kva).split([self.kv_lora, rope], -1)
        kv = F.linear(self.kv_norm(c_kv), self.w_kvb).view(b, l, h, nope + dv)
        k_nope, v = kv.split([nope, dv], -1)
        cos, sin = self.rope_tables(l)
        dt = v.dtype
        q_pe = rotate_pairs(q_pe, cos, sin).to(dt)
        k_pe = rotate_pairs(k_pe[:, :, None, :], cos, sin).to(dt).expand(b, l, h, rope)
        # [B, H, L, D], fresh and contiguous: the kernels take 16-byte aligned inputs
        q = torch.cat((q_nope, q_pe), -1).transpose(1, 2).contiguous()
        k = torch.cat((k_nope, k_pe), -1).transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()
        o = multihead_attention(q, k, v, key_padding_mask, causal=True, scale=self.softmax_scale)
        return F.linear(o.transpose(1, 2).reshape(b, l, h * dv), self.w_o)
