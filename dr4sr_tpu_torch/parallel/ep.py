"""Embedding-parallel (EP) gathers of a row-sharded item table.

Port of ``dr4sr_tpu/parallel/ep.py``. With the item table row-sharded over
the ``model`` axis (``MeshPlan(shard_embedding=True)``):

* each ``model`` rank holds N/S contiguous rows, N padded up to a multiple
  of S (:func:`pad_rows`; 61 → 62 at S = 2);
* :func:`ep_gather` looks up the ids a rank owns and writes 0 elsewhere,
  then :func:`collectives.all_reduce_sum` over ``model`` combines the
  ranks: the communication is the gathered embeddings, B·L·D values, not
  the table's N·D;
* its backward is ``F.embedding``'s local scatter-add of the incoming
  cotangent into the rank's shard (the all-reduce's backward is the
  identity), so no collective of table size is made either;
* :func:`full_table` is the whole table on every rank, for the graph
  models' propagation, which reads every row: an all-gather over
  ``model`` cut to the real rows.

The active plan is process-global, as in the JAX package (one model and
one mesh per process): the trainer installs it around every step and eval
(:func:`ep_plan`). With no plan, or S = 1, every function here is plain
``table[ids]``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dr4sr_tpu_torch.parallel.collectives import all_reduce_sum, gather_seq
from dr4sr_tpu_torch.parallel.mesh import MODEL_AXIS, MeshPlan

_PLAN: Optional[MeshPlan] = None


def set_plan(plan: Optional[MeshPlan]) -> None:
    """Install (or clear, with None) the EP plan used by :func:`ep_gather`
    and :func:`padded_rows`."""
    global _PLAN
    _PLAN = plan


def get_plan() -> Optional[MeshPlan]:
    return _PLAN


@contextlib.contextmanager
def ep_plan(plan: Optional[MeshPlan]):
    """``plan`` installed for the body; the previous plan restored after."""
    prev = _PLAN
    set_plan(plan)
    try:
        yield
    finally:
        set_plan(prev)


def pad_rows(n: int, plan: Optional[MeshPlan]) -> int:
    """Table rows padded up so every ``model`` shard is the same size."""
    if plan is None:
        return n
    s = plan.model_size
    return -(-n // s) * s


def padded_rows(n: int) -> int:
    """Item-table rows under the active plan: models declare their table
    with this many rows. Identity when no plan is installed."""
    return pad_rows(n, _PLAN)


def ep_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a row-sharded ``table`` (this rank's [N/S, D]
    rows): a local lookup of the owned ids, then a sum over ``model``."""
    plan = _PLAN
    if plan is None or plan.model_size <= 1:
        return F.embedding(ids, table)
    model = plan.axis(MODEL_AXIS)
    n_local = table.shape[0]
    loc = ids - model.index * n_local
    owned = (loc >= 0) & (loc < n_local)
    emb = F.embedding(loc.clamp(0, n_local - 1), table) * owned.unsqueeze(-1).to(table.dtype)
    return all_reduce_sum(emb, model)


def embed_lookup(embedding: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """EP-aware replacement for ``embedding(ids)`` on the item table."""
    return ep_gather(embedding.weight, ids)


def full_table(table: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The first ``num_rows`` rows of the whole item table [num_rows, D],
    from this rank's rows of a row-sharded ``table`` (the table itself
    without a plan). The gather takes ``gather_seq``'s backward, the rank's
    own rows of the cotangent and no communication: every rank of a
    ``model`` group computes the same loss from the whole table, so the
    cotangent is replicated over the axis. (Under data parallelism the
    InfoNCE views take ``gather_rows``' rule instead, whose ranks' losses
    differ.)"""
    plan = _PLAN
    if plan is None or plan.model_size <= 1:
        return table[:num_rows]
    return gather_seq(table, plan.axis(MODEL_AXIS), dim=0)[:num_rows]
