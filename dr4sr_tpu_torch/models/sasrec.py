"""SASRec — causal transformer sequence encoder.

Port of ``dr4sr_tpu/models/sasrec.py``: item embedding + learned absolute
positions → dropout → post-norm causal TransformerEncoder with a key-padding
mask → pooling ('origin' per-position queries when training, 'last' in eval
mode). Keeps the ``batch['input_weight']`` multiplier and the
``batch['seq_emb']`` direct-embedding hooks.

The item table has ``parallel.ep.padded_rows`` rows and is read through
``parallel.ep.embed_lookup``, as in the JAX package: both are plain
``nn.Embedding`` without an EP plan, and row-sharded under one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from dr4sr_tpu_torch.models.base import item_embedding
from dr4sr_tpu_torch.models.registry import register_model
from dr4sr_tpu_torch.modules.layers import TransformerEncoder, normal_, seq_pooling
from dr4sr_tpu_torch.parallel.ep import embed_lookup


class SASRecEncoder(nn.Module):
    def __init__(
        self,
        num_items: int,
        embed_dim: int,
        max_seq_len: int,
        num_heads: int,
        hidden_size: int,
        num_layers: int,
        dropout: float,
        activation: str = "gelu",
        layer_norm_eps: float = 1e-12,
        bidirectional: bool = False,
        training_pooling: str = "origin",
        eval_pooling: str = "last",
        extra_embedding_rows: int = 0,  # CL4SRec adds a mask token row
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.bidirectional = bidirectional
        self.training_pooling = training_pooling
        self.eval_pooling = eval_pooling
        self.item_embedding = item_embedding(num_items + extra_embedding_rows, embed_dim,
                                             generator)
        self.position_emb = nn.Embedding(max_seq_len, embed_dim)
        normal_(self.position_emb.weight, generator)
        self.encoder = TransformerEncoder(
            num_layers=num_layers,
            embed_dim=embed_dim,
            num_heads=num_heads,
            ffn_dim=hidden_size,
            dropout=dropout,
            activation=activation,
            layer_norm_eps=layer_norm_eps,
            remat=remat,
            generator=generator,
        )
        self.input_dropout = nn.Dropout(dropout)

    def forward(self, batch: Dict[str, torch.Tensor], need_pooling: bool = True) -> torch.Tensor:
        if batch.get("seq_emb") is None:
            seq = batch["in_item_id"]  # [B, L]
            seq_embs = embed_lookup(self.item_embedding, seq)
            key_padding_mask = seq == 0
        else:
            seq_embs = batch["seq_emb"]
            key_padding_mask = batch.get("key_padding_mask")
        l = seq_embs.shape[1]
        x = seq_embs + self.position_emb(torch.arange(l, device=seq_embs.device))[None]
        if batch.get("input_weight") is not None:
            x = batch["input_weight"][..., None] * x
        x = self.input_dropout(x)
        out = self.encoder(x, key_padding_mask=key_padding_mask, causal=not self.bidirectional)
        if not need_pooling:
            return out
        pooling = self.training_pooling if self.training else self.eval_pooling
        return seq_pooling(out, batch["seqlen"], pooling)


@register_model("SASRec")
class SASRec:
    """Architecture factory: builds the module from a layered config."""

    @staticmethod
    def build(
        config: Dict[str, Any],
        num_items: int,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ) -> nn.Module:
        m = config["model"]
        return SASRecEncoder(
            num_items=num_items,
            embed_dim=int(m["embed_dim"]),
            max_seq_len=int(config["data"]["max_seq_len"]),
            num_heads=int(m["head_num"]),
            hidden_size=int(m["hidden_size"]),
            num_layers=int(m["layer_num"]),
            dropout=float(m["dropout_rate"]),
            activation=m.get("activation", "gelu"),
            layer_norm_eps=float(m.get("layer_norm_eps", 1e-12)),
            remat=bool(m.get("remat", False)),
            generator=generator,
            **kwargs,
        )
