"""Transformer building blocks and pooling, as ``nn.Module``s.

Port of ``dr4sr_tpu/modules/layers.py:31-159``:

* :func:`length_mask`, :func:`seq_pooling` — every pooling type.
* :class:`TransformerEncoderLayer` — post-norm layer with one fused ``qkv``
  Linear(D, 3D) split as ``[q | k | v]``; attention goes through
  :func:`dr4sr_tpu_torch.ops.attention.multihead_attention` (the CUDA kernel
  on the card), never ``nn.MultiheadAttention`` or SDPA.
* :class:`TransformerEncoder` — a stack of them; ``remat`` recomputes each
  layer on the backward pass (``torch.utils.checkpoint``).

flax's ``nn.gelu`` is the tanh approximation, so ``"gelu"`` here is
``F.gelu(approximate="tanh")``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dr4sr_tpu_torch.ops.attention import multihead_attention


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "identity": lambda x: x,
    }[name.lower()]


def normal_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """normal(0, 0.02) in place, the JAX package's ``normal_init``."""
    with torch.no_grad():
        weight.normal_(0.0, 0.02, generator=generator)


def length_mask(seqlen: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, L] bool, True where position < seqlen (a real token)."""
    return torch.arange(max_len, device=seqlen.device)[None, :] < seqlen[:, None]


def seq_pooling(
    x: torch.Tensor,  # [B, L, D]
    seqlen: torch.Tensor,  # [B]
    pooling_type: str = "mean",
    weight: Optional[torch.Tensor] = None,  # [B, L]
    mask_token: Optional[torch.Tensor] = None,  # [B, L] bool, for 'mask' pooling
) -> torch.Tensor:
    """Pooling over valid positions; ``origin`` zeroes padded positions and
    ``mask`` gathers the first True position of ``mask_token`` per row."""
    b, l, d = x.shape
    rows = torch.arange(b, device=x.device)
    if weight is not None:
        x = x * weight[..., None]
    if pooling_type == "mask":
        if mask_token is None:
            raise ValueError("mask pooling needs mask_token")
        return x[rows, torch.argmax(mask_token.to(torch.uint8), dim=1)]
    if pooling_type == "last":
        return x[rows, torch.clamp(seqlen - 1, 0, l - 1)]
    mask = length_mask(seqlen, l)[..., None]
    x = torch.where(mask, x, 0.0)
    if pooling_type == "origin":
        return x
    if pooling_type == "sum":
        return x.sum(dim=1)
    if pooling_type == "mean":
        return x.sum(dim=1) / torch.clamp(seqlen[:, None], min=1).to(x.dtype)
    if pooling_type == "max":
        return torch.where(mask, x, float("-inf")).amax(dim=1)
    if pooling_type == "concat":
        return x.reshape(b, l * d)
    raise ValueError(f"unknown pooling_type {pooling_type!r}")


class TransformerEncoderLayer(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        ffn_dim: int,
        dropout: float = 0.0,
        activation: str = "gelu",
        layer_norm_eps: float = 1e-12,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim, eps=layer_norm_eps)
        self.ffn1 = nn.Linear(embed_dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=layer_norm_eps)
        self.dropout = nn.Dropout(dropout)
        self.act = _activation(activation)
        for lin in (self.qkv, self.out_proj, self.ffn1, self.ffn2):
            normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(
        self,
        x: torch.Tensor,  # [B, L, D]
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, L] True = pad
        causal: bool = True,
    ) -> torch.Tensor:
        b, l, d = x.shape
        h = self.num_heads
        q, k, v = (
            t.reshape(b, l, h, d // h).transpose(1, 2).contiguous()
            for t in self.qkv(x).split(d, dim=-1)
        )
        attn = multihead_attention(q, k, v, key_padding_mask, causal)
        attn = self.dropout(self.out_proj(attn.transpose(1, 2).reshape(b, l, d)))
        x = self.norm1(x + attn)
        y = self.dropout(self.act(self.ffn1(x)))
        y = self.dropout(self.ffn2(y))
        return self.norm2(x + y)


class TransformerEncoder(nn.Module):
    def __init__(
        self,
        num_layers: int,
        embed_dim: int,
        num_heads: int,
        ffn_dim: int,
        dropout: float = 0.0,
        activation: str = "gelu",
        layer_norm_eps: float = 1e-12,
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(
                embed_dim, num_heads, ffn_dim, dropout, activation, layer_norm_eps, generator
            )
            for _ in range(num_layers)
        )

    def forward(self, x, key_padding_mask=None, causal=True):
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, key_padding_mask, causal, use_reentrant=False)
            else:
                x = layer(x, key_padding_mask, causal)
        return x
