"""Shared model machinery for serving: the item table, eval encoding, top-k.

Port of the eval half of ``dr4sr_tpu/models/base.py``. Conventions as there:
every architecture exposes an ``item_embedding`` (here an ``nn.Embedding``),
whose weight is the scoring table, and its ``forward(batch)`` returns the
query ([B, D] in eval mode). ``training_loss``, negative sampling and the
losses come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from dr4sr_tpu_torch.modules.layers import normal_
from dr4sr_tpu_torch.ops.topk import masked_topk_scores

Batch = Dict[str, torch.Tensor]


def embedding_init_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """normal(0.02) with the PAD row zeroed, in place."""
    normal_(weight, generator)
    with torch.no_grad():
        weight[0].zero_()


def item_table(module: nn.Module) -> torch.Tensor:
    return module.item_embedding.weight


@dataclasses.dataclass
class RecModel:
    """Bundles an architecture module with its config."""

    config: Dict[str, Any]
    module: nn.Module
    num_items: int
    num_users: int

    @property
    def max_seq_len(self) -> int:
        return int(self.config["data"]["max_seq_len"])

    def encode_eval(self, batch: Batch) -> torch.Tensor:
        """The query in eval mode (no dropout, eval pooling)."""
        self.module.eval()
        return self.module(batch)

    def topk(
        self,
        batch: Batch,
        k: int,
        item_keep_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-catalog masked top-k: (scores [B, k], items [B, k])."""
        query = self.encode_eval(batch)
        table = item_table(self.module)[: self.num_items]
        return masked_topk_scores(
            query, table, min(k, self.num_items), item_keep_mask=item_keep_mask,
            user_hist=batch.get("user_hist"),
        )
