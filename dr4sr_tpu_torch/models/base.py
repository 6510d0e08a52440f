"""Shared model machinery: scoring, losses, negative sampling, eval top-k.

Port of ``dr4sr_tpu/models/base.py``. Conventions as there: every
architecture exposes an ``item_embedding`` (here an ``nn.Embedding``), whose
weight is the scoring table, and its ``forward(batch)`` returns the query —
[B, L, D] in train mode with 'origin' pooling, else [B, D]. The dot-product
scoring broadcast matches the reference (``model/basemodel.py:204-210``):
the query broadcasts from the left against per-position positives [B, L]
and negatives [B, L, 1].

The JAX package threads params and an rng key through pure functions; here
the module holds its parameters, dropout follows ``module.train()`` /
``module.eval()``, and negatives are drawn from an explicit
``torch.Generator`` on the batch's device.

Under a mesh, the positive and negative rows are gathered through
``parallel.ep.ep_gather`` (a row-sharded table under EP, plain
``F.embedding`` otherwise), and with ``RecModel.data_axis`` set the
negatives are drawn for the *global* batch on every rank, from generators
in lockstep, and each rank keeps its rows; the loss then divides by the
global batch's count (``modules/losses.py``). So data parallelism at
dropout 0 takes the steps one process takes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from dr4sr_tpu_torch.modules.layers import normal_
from dr4sr_tpu_torch.modules.losses import (
    alignment,
    binary_cross_entropy_loss,
    bpr_loss,
    uniformity,
)
from dr4sr_tpu_torch.ops.topk import masked_topk_scores
from dr4sr_tpu_torch.parallel.collectives import Axis
from dr4sr_tpu_torch.parallel.ep import ep_gather, padded_rows

Batch = Dict[str, torch.Tensor]


def embedding_init_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """normal(0.02) with the PAD row zeroed, in place."""
    normal_(weight, generator)
    with torch.no_grad():
        weight[0].zero_()


def item_embedding(num_rows: int, embed_dim: int,
                   generator: Optional[torch.Generator]) -> nn.Embedding:
    """The item table of a model that EP may shard: ``padded_rows(num_rows)``
    rows (shard-aligned under an installed EP plan, as the JAX models declare
    it), the first ``num_rows`` drawn by :func:`embedding_init_` (the same
    draws as an unpadded table), the padding rows 0; no id reaches them."""
    emb = nn.Embedding(padded_rows(num_rows), embed_dim)
    with torch.no_grad():
        embedding_init_(emb.weight[:num_rows], generator)
        emb.weight[num_rows:].zero_()
    return emb


def item_table(module: nn.Module) -> torch.Tensor:
    return module.item_embedding.weight


def dot_score(query: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Sum-product with left-broadcast of the query over extra emb axes."""
    extra = emb.dim() - query.dim()
    q = query.reshape(query.shape[:-1] + (1,) * extra + query.shape[-1:])
    return (q * emb).sum(dim=-1)


def sample_negatives(
    generator: torch.Generator, batch: Batch, num_items: int, max_seq_len: int,
    axis: Optional[Axis] = None,
) -> torch.Tensor:
    """Uniform negatives over [1, num_items) (reference ``_neg_sampling``,
    ``model/basemodel.py:50-61``): [B, L, 1] for per-position targets, [B, 1]
    for single targets. ``generator`` lives on the batch's device. Given the
    ``data`` axis, the draw is for the global batch (B × axis size rows) and
    this rank keeps its rows."""
    item_id = batch["item_id"]
    rows = item_id.shape[0] * (1 if axis is None else axis.size)
    shape = (rows, max_seq_len, 1) if item_id.dim() == 2 else (rows, 1)
    neg = torch.randint(1, num_items, shape, generator=generator, device=item_id.device)
    return neg if axis is None else axis.chunk(neg, 0)


def pos_neg_scores(
    query: torch.Tensor, table: torch.Tensor, batch: Batch, neg_id: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (pos_score, neg_score, mask). ``mask`` True = real position;
    a batch's ``valid`` row mask (the padded last batch) also applies.
    The rows are gathered with ``ep_gather`` (``F.embedding`` without an EP
    plan), whose backward sums repeated ids in parallel; advanced indexing's
    backward walks each id's repeats serially, and the PAD id repeats in
    most positions."""
    pos_score = dot_score(query, ep_gather(table, batch["item_id"]))
    neg_score = dot_score(query, ep_gather(table, neg_id))
    mask = batch["item_id"] != 0
    if "valid" in batch:
        valid = batch["valid"]
        mask = mask & valid.reshape(valid.shape + (1,) * (mask.dim() - 1))
    return pos_score, neg_score, mask


LOSS_FNS: Dict[str, Callable] = {
    "bce": binary_cross_entropy_loss,
    "bpr": bpr_loss,
}


@dataclasses.dataclass
class RecModel:
    """Bundles an architecture module with its config; ``data_axis`` is the
    mesh's ``data`` axis under data parallelism (global negatives and
    denominators), else None."""

    config: Dict[str, Any]
    module: nn.Module
    num_items: int
    num_users: int
    data_axis: Optional[Axis] = None

    @property
    def max_seq_len(self) -> int:
        return int(self.config["data"]["max_seq_len"])

    @property
    def loss_fn(self) -> Callable:
        return LOSS_FNS[self.config["model"].get("loss_fn", "bce")]

    # -- training ----------------------------------------------------------
    def training_loss(
        self,
        batch: Batch,
        generator: Optional[torch.Generator],
        neg_id: Optional[torch.Tensor] = None,
        reduce: bool = True,
        return_query: bool = False,
    ):
        """Forward in train mode + BCE/BPR loss (reference ``training_step``,
        ``model/basemodel.py:204-214``). Negatives come from ``generator``
        unless ``neg_id`` gives them."""
        self.module.train()
        query = self.module(batch)
        if neg_id is None:
            neg_id = sample_negatives(generator, batch, self.num_items, self.max_seq_len,
                                      self.data_axis)
        pos, neg, mask = pos_neg_scores(query, item_table(self.module), batch, neg_id)
        loss = self.loss_fn(pos, neg, mask, reduce=reduce, axis=self.data_axis)
        if return_query:
            return loss, query
        return loss

    def alignment_uniformity_loss(self, batch: Batch) -> torch.Tensor:
        """Representation-quality objective (reference ``SASRec.training_step``
        with ``align=True``): alignment(query, pos_emb) + uniformity(query)
        + uniformity(pos_emb) over valid positions."""
        self.module.train()
        query = self.module(batch)
        pos_emb = ep_gather(item_table(self.module), batch["item_id"])
        extra = pos_emb.dim() - query.dim()
        d = query.shape[-1]
        q = query.reshape(query.shape[:-1] + (1,) * extra + (d,)).expand(pos_emb.shape)
        valid = (batch["item_id"] != 0).reshape(-1)
        qf, pf = q.reshape(-1, d), pos_emb.reshape(-1, d)
        return alignment(qf, pf, valid) + uniformity(qf, valid) + uniformity(pf, valid)

    # -- eval --------------------------------------------------------------
    def encode_eval(self, batch: Batch) -> torch.Tensor:
        """The query in eval mode (no dropout, eval pooling); the module's
        previous train/eval mode is restored afterwards."""
        was_training = self.module.training
        self.module.eval()
        try:
            return self.module(batch)
        finally:
            self.module.train(was_training)

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
