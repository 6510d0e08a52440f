"""The regenerator: a diversity-promoted seq2seq transformer.

Port of ``dr4sr_tpu/regen/generator.py``, with its semantics:

* one item table for the catalog and SOS = ``num_items``, EOS =
  ``num_items + 1``, normal(0.02) with the PAD row zeroed (not frozen);
* encoder (2 post-norm layers, D = 64, 2 heads, FFN 256, tanh-gelu,
  LayerNorm eps 1e-12), **causal** in training and non-causal at decode;
* ``condition_linear`` maps the memory [B, L, D] to K latent memories
  [B, L, K, D] (K major in the last axis); a :class:`ConditionEncoder`
  (2 causal layers over the target, mean pool, MLP → K, gumbel-softmax at
  temperature τ) mixes them in training; decoding forces one condition per
  lane;
* decoder (2 layers) with cross-attention over the mixed memory; logits
  tied to the table (``out @ E.T``, a plain ``torch.matmul``) and limited
  to the items of the source;
* loss: CE over non-PAD targets + ``entropy_weight`` · H(condition).

Every attention of the encoder, the condition encoder and the decoder's
full-sequence pass goes through ``ops.attention.multihead_attention``, so
through the CUDA kernels on the card. Gumbel noise comes from the caller's
``torch.Generator``, or is given as a tensor (``gumbel``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dr4sr_tpu_torch.models.base import embedding_init_
from dr4sr_tpu_torch.modules.layers import (
    MLP,
    TransformerDecoder,
    TransformerEncoder,
    normal_,
    seq_pooling,
)

NEG = -1e30


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class ConditionEncoder(nn.Module):
    """Target-side condition picker: (condition probabilities [B, K], logits)."""

    def __init__(self, k: int, embed_dim: int = 64, num_heads: int = 2, ffn_dim: int = 256,
                 dropout: float = 0.5, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.encoder = TransformerEncoder(2, embed_dim, num_heads, ffn_dim, dropout, "gelu",
                                          1e-12, generator=generator)
        self.condition_layer = MLP(embed_dim, (embed_dim, k), generator=generator)

    def forward(
        self,
        tgt_emb: torch.Tensor,  # [B, Lt, D]
        tgt_padding_mask: torch.Tensor,  # [B, Lt] True = pad
        tgt_seqlen: torch.Tensor,  # [B]
        tau: float,
        gumbel: Optional[torch.Tensor] = None,  # [B, K] noise, or None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.encoder(tgt_emb, tgt_padding_mask, causal=True)
        logits = self.condition_layer(seq_pooling(out, tgt_seqlen, "mean"))
        if gumbel is not None:
            return F.softmax((logits + gumbel) / tau, dim=-1), logits
        return F.softmax(logits / tau, dim=-1), logits


class Generator(nn.Module):
    """Seq2seq regenerator with K-way conditioned memory."""

    def __init__(
        self,
        num_items: int,
        k: int = 5,
        embed_dim: int = 64,
        num_heads: int = 2,
        num_layers: int = 2,
        ffn_dim: int = 256,
        dropout: float = 0.5,
        max_len: int = 64,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_items = num_items
        self.k = k
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.ffn_dim = ffn_dim
        self.max_len = max_len
        self.item_embedding = nn.Embedding(num_items + 2, embed_dim)
        embedding_init_(self.item_embedding.weight, generator)
        self.position_embedding = nn.Embedding(max_len, embed_dim)
        normal_(self.position_embedding.weight, generator)
        self.encoder = TransformerEncoder(num_layers, embed_dim, num_heads, ffn_dim, dropout,
                                          "gelu", 1e-12, generator=generator)
        self.decoder = TransformerDecoder(num_layers, embed_dim, num_heads, ffn_dim, dropout,
                                          "gelu", 1e-12, generator=generator)
        self.condition_linear = MLP(embed_dim, (embed_dim * k, embed_dim * k),
                                    generator=generator)
        self.condition_encoder = ConditionEncoder(k, embed_dim, num_heads, ffn_dim, dropout,
                                                  generator)
        self.input_dropout = nn.Dropout(dropout)

    @property
    def sos(self) -> int:
        return self.num_items

    @property
    def eos(self) -> int:
        return self.num_items + 1

    def widths(self) -> Dict[str, int]:
        """What :meth:`__init__` needs besides the weights (checkpoint metadata)."""
        return {"num_items": self.num_items, "k": self.k, "embed_dim": self.embed_dim,
                "num_heads": self.num_heads, "num_layers": self.num_layers,
                "ffn_dim": self.ffn_dim, "max_len": self.max_len}

    # ----------------------------------------------------------------- pieces
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return self.input_dropout(self.item_embedding(tokens) + self.position_embedding(pos))

    def encode(self, src: torch.Tensor, causal: bool) -> torch.Tensor:
        """Encoder memory [B, Ls, D]: causal in training (a quirk of the
        reference kept here), non-causal at decode."""
        return self.encoder(self.embed(src), src == 0, causal)

    def conditioned_memory(self, memory: torch.Tensor) -> torch.Tensor:
        """[B, L, D] -> [B, L, K, D] latent memories."""
        b, l, d = memory.shape
        return self.condition_linear(memory).reshape(b, l, self.k, d)

    def logits_from(self, out: torch.Tensor) -> torch.Tensor:
        """Tied logits in f32: a bf16 decoder output and table are widened
        first, so the products are exact and the sums f32, as JAX's
        ``preferred_element_type=float32``."""
        return torch.matmul(out.float(), self.item_embedding.weight.float().t())

    # ------------------------------------------------------------------ train
    def forward(
        self,
        src: torch.Tensor,  # [B, Ls] SOS/EOS-framed, 0-padded
        tgt_in: torch.Tensor,  # [B, Lt] target input (starts with SOS)
        tgt_seqlen: torch.Tensor,  # [B]
        tau: float,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [B, Lt, N+2] limited to the source's items, condition
        probabilities [B, K]). In train mode (``module.train()``) the
        condition takes gumbel noise: ``gumbel`` if given, else drawn from
        ``generator``; in eval mode none, and no dropout."""
        memory = self.encode(src, causal=True)
        mem_k = self.conditioned_memory(memory)
        tgt_emb = self.embed(tgt_in)
        if self.training and gumbel is None:
            gumbel = gumbel_noise((src.shape[0], self.k), generator, src.device)
        cond, _ = self.condition_encoder(tgt_emb, tgt_in == 0, tgt_seqlen, tau,
                                         gumbel if self.training else None)
        memory_cond = torch.einsum("blkd,bk->bld", mem_k, cond)
        out = self.decoder(tgt_emb, memory_cond, tgt_in == 0, src == 0, causal=True)
        logits = self.logits_from(out)
        # every source token, PAD/SOS/EOS included, as a [B, 1, V] mask
        keep = torch.zeros(src.shape[0], logits.shape[-1], dtype=torch.bool, device=src.device)
        keep.scatter_(1, src.long(), True)
        return torch.where(keep[:, None, :], logits, NEG), cond

    # -------------------------------------------------------------- inference
    def select_condition(self, memory_k: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        """[B, L, K, D] and [B] condition indices -> [B, L, D]."""
        b, l, _, d = memory_k.shape
        idx = condition.long()[:, None, None, None].expand(b, l, 1, d)
        return memory_k.gather(2, idx)[:, :, 0]

    def decode_state(self, src: torch.Tensor, condition: torch.Tensor):
        """Once per decode: encode (non-causal), pick each lane's memory and
        project every layer's cross-attention k, v: ([nl, B, Ls, D],) * 2."""
        memory_k = self.conditioned_memory(self.encode(src, causal=False))
        return self.decoder.project_memory(self.select_condition(memory_k, condition))

    def cached_decode_step(self, tok, pos: int, cache_k, cache_v, mem_k, mem_v, memory_valid):
        """One incremental decoder position over the K/V caches (written in
        place): logits [B, V]."""
        x = self.item_embedding(tok) + self.position_embedding.weight[pos]
        return self.logits_from(
            self.decoder.step(x, cache_k, cache_v, pos, mem_k, mem_v, memory_valid))

    def decode_step(self, tgt_buf, memory_k, src_pad, condition, step: int) -> torch.Tensor:
        """One full-buffer step: the decoder over the whole prefix buffer
        [B, Lmax], logits [B, V] at position ``step``."""
        out = self.decoder(self.embed(tgt_buf), self.select_condition(memory_k, condition),
                           tgt_buf == 0, src_pad, causal=True)
        return self.logits_from(out[:, step])


def generator_loss(
    logits: torch.Tensor,  # [B, Lt, V]
    targets: torch.Tensor,  # [B, Lt] (0 = ignore)
    cond: torch.Tensor,  # [B, K]
    entropy_weight: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE (ignoring PAD) + ``entropy_weight`` · mean entropy of the
    condition probabilities (the reference penalises entropy, pushing each
    sample toward one condition)."""
    mask = targets != 0
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    ce = torch.where(mask, nll, 0.0).sum() / mask.sum().clamp_min(1)
    ent = -(cond * torch.log(cond + 1e-12)).sum(dim=-1).mean()
    return ce + entropy_weight * ent, {"ce": ce, "entropy": ent}


def frame_pairs(pairs, num_items: int, max_src: int = 52, max_tgt: int = 27) -> Dict[str, np.ndarray]:
    """(sequence, pattern) pairs -> SOS/EOS-framed, 0-padded arrays
    ``src`` [n, max_src], ``tgt`` [n, max_tgt] and their lengths."""
    sos, eos = num_items, num_items + 1
    n = len(pairs)
    src = np.zeros((n, max_src), np.int32)
    tgt = np.zeros((n, max_tgt), np.int32)
    src_len = np.zeros(n, np.int32)
    tgt_len = np.zeros(n, np.int32)
    for i, (s, t) in enumerate(pairs):
        s = [sos] + list(s)[: max_src - 2] + [eos]
        t = [sos] + list(t)[: max_tgt - 2] + [eos]
        src[i, : len(s)] = s
        tgt[i, : len(t)] = t
        src_len[i] = len(s)
        tgt_len[i] = len(t)
    return {"src": src, "tgt": tgt, "src_len": src_len, "tgt_len": tgt_len}
