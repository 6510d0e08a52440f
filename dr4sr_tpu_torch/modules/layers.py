"""Transformer building blocks and pooling, as ``nn.Module``s.

Port of ``dr4sr_tpu/modules/layers.py:31-355`` and ``:525-538``:

* :func:`length_mask`, :func:`seq_pooling` — every pooling type.
* :class:`TransformerEncoderLayer` — post-norm layer with one fused ``qkv``
  Linear(D, 3D) split as ``[q | k | v]``; attention goes through
  :func:`dr4sr_tpu_torch.ops.attention.multihead_attention` (the CUDA kernel
  on the card), never ``nn.MultiheadAttention`` or SDPA.
* :class:`TransformerEncoder` — a stack of them; ``remat`` recomputes each
  layer on the backward pass (``torch.utils.checkpoint``).
* :class:`TransformerDecoderLayer`, :class:`TransformerDecoder` — the
  regenerator's post-norm decoder: causal self-attention, cross-attention
  over the encoder memory (both through ``multihead_attention``), FFN; and
  the KV-cached path for decoding (``project_memory`` once, then ``step``
  per position), whose one-query attention :func:`_attend_one` is plain
  PyTorch, as the JAX package computes it outside Pallas.
* :class:`MLP` — ``dense_i`` Linear layers with relu between them.
* :func:`gru_stack` — GRU4Rec's bias-free multi-layer GRU (``GRUStack``,
  ``:358-423``): ``nn.GRU(bias=False, batch_first=True)``, every weight
  U(−1/√H, 1/√H) from the caller's generator. JAX runs the recurrence as a
  ``lax.scan`` outside Pallas; here it is cuDNN's on the card.
* :class:`FilterLayer`, :class:`FMLPLayer`, :class:`FMLPEncoder` — FMLP's
  learnable frequency filter (``:452-522``) by ``torch.fft``.

flax's ``nn.gelu`` is the tanh approximation, so ``"gelu"`` here is
``F.gelu(approximate="tanh")``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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


def _linear(d_in: int, d_out: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """A flax ``Dense`` with ``normal_init``: weight normal(0.02), bias 0."""
    lin = nn.Linear(d_in, d_out)
    normal_(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, D/H], a fresh contiguous tensor: the kernels
    take 16-byte aligned inputs, and a ``split`` view sits at an offset."""
    b, l, d = t.shape
    return t.reshape(b, l, h, d // h).transpose(1, 2).contiguous()


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = t.shape
    return t.transpose(1, 2).reshape(b, l, h * dh)


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
        q, k, v = (_heads(t, self.num_heads) for t in self.qkv(x).split(x.shape[-1], dim=-1))
        attn = multihead_attention(q, k, v, key_padding_mask, causal)
        x = self.norm1(x + self.dropout(self.out_proj(_merge(attn))))
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


def _attend_one(
    q: torch.Tensor,  # [B, D] single query position
    k: torch.Tensor,  # [B, L, D]
    v: torch.Tensor,  # [B, L, D]
    valid: torch.Tensor,  # [B, L] bool, True = attend
    num_heads: int,
) -> torch.Tensor:
    """One query row against a cache: the math of ``mha_reference`` for one
    row (same scale, -1e30 fill, safe softmax), scores and p·v in f32."""
    b, l, d = k.shape
    dh = d // num_heads
    qh = q.reshape(b, num_heads, dh).float()
    kh = k.reshape(b, l, num_heads, dh).float()
    scores = torch.einsum("bhd,blhd->bhl", qh, kh) / (dh**0.5)
    scores = scores.masked_fill(~valid[:, None, :], -1e30)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    e = torch.where(scores <= -5e29, 0.0, e)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhl,blhd->bhd", p, v.reshape(b, l, num_heads, dh).float())
    return out.reshape(b, d).to(q.dtype)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: causal self-attention → cross-attention over
    the encoder memory → FFN. Parameter names are the flax module's."""

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
        d = embed_dim
        self.num_heads = num_heads
        self.self_qkv = _linear(d, 3 * d, generator)
        self.self_out = _linear(d, d, generator)
        self.norm1 = nn.LayerNorm(d, eps=layer_norm_eps)
        self.cross_q = _linear(d, d, generator)
        self.cross_kv = _linear(d, 2 * d, generator)
        self.cross_out = _linear(d, d, generator)
        self.norm2 = nn.LayerNorm(d, eps=layer_norm_eps)
        self.ffn1 = _linear(d, ffn_dim, generator)
        self.ffn2 = _linear(ffn_dim, d, generator)
        self.norm3 = nn.LayerNorm(d, eps=layer_norm_eps)
        self.dropout = nn.Dropout(dropout)
        self.act = _activation(activation)

    def forward(
        self,
        x: torch.Tensor,  # [B, Lt, D] target stream
        memory: torch.Tensor,  # [B, Ls, D] encoder output
        tgt_key_padding_mask: Optional[torch.Tensor] = None,  # [B, Lt] True = pad
        memory_key_padding_mask: Optional[torch.Tensor] = None,  # [B, Ls]
        causal: bool = True,
    ) -> torch.Tensor:
        d = x.shape[-1]
        h = self.num_heads
        q, k, v = (_heads(t, h) for t in self.self_qkv(x).split(d, dim=-1))
        attn = multihead_attention(q, k, v, tgt_key_padding_mask, causal)
        x = self.norm1(x + self.dropout(self.self_out(_merge(attn))))

        k, v = (_heads(t, h) for t in self.cross_kv(memory).split(d, dim=-1))
        cross = multihead_attention(_heads(self.cross_q(x), h), k, v,
                                    memory_key_padding_mask, False)
        x = self.norm2(x + self.dropout(self.cross_out(_merge(cross))))

        y = self.dropout(self.act(self.ffn1(x)))
        return self.norm3(x + self.dropout(self.ffn2(y)))

    def project_memory(self, memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Once-per-decode cross-attention (k, v), each [B, Ls, D]."""
        k, v = self.cross_kv(memory).split(memory.shape[-1], dim=-1)
        return k, v

    def step(
        self,
        x: torch.Tensor,  # [B, D] embedded token at position `pos`
        cache_k: torch.Tensor,  # [B, Lmax, D] self-attention key cache, written at pos
        cache_v: torch.Tensor,  # [B, Lmax, D]
        pos: int,
        mem_k: torch.Tensor,  # [B, Ls, D] from project_memory
        mem_v: torch.Tensor,
        memory_valid: torch.Tensor,  # [B, Ls] bool, True = real memory position
    ) -> torch.Tensor:
        """One decode position; writes this position's k, v into the caches
        in place and returns y [B, D]."""
        d = x.shape[-1]
        q, k, v = self.self_qkv(x).split(d, dim=-1)
        cache_k[:, pos] = k
        cache_v[:, pos] = v
        valid = (torch.arange(cache_k.shape[1], device=x.device) <= pos).expand(cache_k.shape[:2])
        x = self.norm1(x + self.self_out(_attend_one(q, cache_k, cache_v, valid, self.num_heads)))
        cross = _attend_one(self.cross_q(x), mem_k, mem_v, memory_valid, self.num_heads)
        x = self.norm2(x + self.cross_out(cross))
        return self.norm3(x + self.ffn2(self.act(self.ffn1(x))))


class TransformerDecoder(nn.Module):
    def __init__(
        self,
        num_layers: int,
        embed_dim: int,
        num_heads: int,
        ffn_dim: int,
        dropout: float = 0.0,
        activation: str = "gelu",
        layer_norm_eps: float = 1e-12,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(
                embed_dim, num_heads, ffn_dim, dropout, activation, layer_norm_eps, generator
            )
            for _ in range(num_layers)
        )

    def forward(self, x, memory, tgt_key_padding_mask=None, memory_key_padding_mask=None,
                causal=True):
        for layer in self.layers:
            x = layer(x, memory, tgt_key_padding_mask, memory_key_padding_mask, causal)
        return x

    def project_memory(self, memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-layer cross (k, v), each [num_layers, B, Ls, D]."""
        ks, vs = zip(*(layer.project_memory(memory) for layer in self.layers))
        return torch.stack(ks), torch.stack(vs)

    def step(self, x, cache_k, cache_v, pos, mem_k, mem_v, memory_valid) -> torch.Tensor:
        """One position through every layer; the caches [num_layers, B, Lmax, D]
        are written in place. Returns y [B, D]."""
        for i, layer in enumerate(self.layers):
            x = layer.step(x, cache_k[i], cache_v[i], pos, mem_k[i], mem_v[i], memory_valid)
        return x


class MLP(nn.Module):
    """``dense_0 .. dense_{n-1}`` (weights normal(0.02), bias 0) with the
    activation between layers, not after the last."""

    def __init__(
        self,
        in_features: int,
        features: Sequence[int],
        activation: str = "relu",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.act = _activation(activation)
        self.num_layers = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", _linear(in_features, f, generator))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i + 1 < self.num_layers:
                x = self.act(x)
        return x


def gru_stack(
    input_size: int, hidden_size: int, num_layers: int,
    generator: Optional[torch.Generator] = None,
) -> nn.GRU:
    """Bias-free GRU over [B, L, Din] -> [B, L, H] (gates r, z, n in the JAX
    ``GRUStack``'s order) with every weight drawn U(−1/√H, 1/√H) from
    ``generator``, torch's own default range. It runs over all L positions,
    padding included, as the JAX scan does."""
    gru = nn.GRU(input_size, hidden_size, num_layers=num_layers, bias=False, batch_first=True)
    bound = 1.0 / hidden_size**0.5
    with torch.no_grad():
        for w in gru.parameters():
            w.uniform_(-bound, bound, generator=generator)
    return gru


class FilterLayer(nn.Module):
    """Learnable frequency-domain filter: rfft over the sequence axis →
    pointwise complex weight → irfft (both ``norm="ortho"``), dropout, then
    LayerNorm of the residual. ``complex_weight`` is [1, L//2+1, D, 2]
    (real, imaginary).

    The JAX package computes the same map as a real [L, L, D] operator in
    one einsum by default (a TPU workaround; ``use_fft=True`` takes
    ``jnp.fft``). The FFT runs in f32 whatever the input's dtype: cuFFT has
    no bf16. Under bf16 autocast the layer therefore gets and returns f32
    where JAX's bf16 path runs the einsum in bf16, so the two bf16 results
    differ; only f32 is held to JAX's."""

    def __init__(
        self, max_seq_len: int, embed_dim: int, dropout: float = 0.5,
        layer_norm_eps: float = 1e-12, generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.complex_weight = nn.Parameter(torch.empty(1, max_seq_len // 2 + 1, embed_dim, 2))
        normal_(self.complex_weight, generator)
        self.dropout = nn.Dropout(dropout)
        self.norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, D]
        l = x.shape[1]
        fx = torch.fft.rfft(x.float(), dim=1, norm="ortho")
        w = self.complex_weight[:, : fx.shape[1]]
        fx = fx * torch.complex(w[..., 0], w[..., 1])
        y = torch.fft.irfft(fx, n=l, dim=1, norm="ortho").to(x.dtype)
        return self.norm(self.dropout(y) + x)


class FMLPLayer(nn.Module):
    """The filter, then a 4·D gelu FFN with dropout and a post-norm residual."""

    def __init__(
        self, max_seq_len: int, embed_dim: int, dropout: float = 0.5,
        layer_norm_eps: float = 1e-12, generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.filter = FilterLayer(max_seq_len, embed_dim, dropout, layer_norm_eps, generator)
        self.ffn1 = _linear(embed_dim, 4 * embed_dim, generator)
        self.ffn2 = _linear(4 * embed_dim, embed_dim, generator)
        self.dropout = nn.Dropout(dropout)
        self.norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.filter(x)
        y = self.ffn2(F.gelu(self.ffn1(x), approximate="tanh"))
        return self.norm(self.dropout(y) + x)


class FMLPEncoder(nn.Module):
    def __init__(
        self, num_layers: int, max_seq_len: int, embed_dim: int, dropout: float = 0.5,
        layer_norm_eps: float = 1e-12, generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            FMLPLayer(max_seq_len, embed_dim, dropout, layer_norm_eps, generator)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
