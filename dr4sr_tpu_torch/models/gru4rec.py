"""GRU4Rec — recurrent sequence encoder.

Port of ``dr4sr_tpu/models/gru4rec.py``: item embedding → dropout → a
2-layer bias-free GRU (hidden 256) → ``out_proj`` Linear (with bias) back to
the embedding width → 'origin' pooling in train mode, 'last' in eval mode.
No attention: the recurrence is ``nn.GRU`` (cuDNN on the card), as JAX runs
it in a ``lax.scan`` outside Pallas.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from dr4sr_tpu_torch.models.base import embedding_init_
from dr4sr_tpu_torch.models.registry import register_model
from dr4sr_tpu_torch.modules.layers import _linear, gru_stack, seq_pooling


class GRU4RecEncoder(nn.Module):
    def __init__(
        self,
        num_items: int,
        embed_dim: int,
        hidden_size: int,
        num_layers: int,
        dropout: float,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.item_embedding = nn.Embedding(num_items, embed_dim)
        embedding_init_(self.item_embedding.weight, generator)
        self.gru = gru_stack(embed_dim, hidden_size, num_layers, generator)
        self.out_proj = _linear(hidden_size, embed_dim, generator)
        self.input_dropout = nn.Dropout(dropout)

    def forward(self, batch: Dict[str, torch.Tensor], need_pooling: bool = True) -> torch.Tensor:
        x = self.input_dropout(self.item_embedding(batch["in_item_id"]))
        out = self.out_proj(self.gru(x)[0])
        if not need_pooling:
            return out
        return seq_pooling(out, batch["seqlen"], "origin" if self.training else "last")


@register_model("GRU4Rec")
class GRU4Rec:
    @staticmethod
    def build(config: Dict[str, Any], num_items: int,
              generator: Optional[torch.Generator] = None, **kwargs) -> nn.Module:
        m = config["model"]
        return GRU4RecEncoder(
            num_items=num_items,
            embed_dim=int(m["embed_dim"]),
            hidden_size=int(m["hidden_size"]),
            num_layers=int(m["layer_num"]),
            dropout=float(m["dropout_rate"]),
            generator=generator,
        )
