"""Full-catalog scoring + masked top-k — the eval and serving hot path.

Port of ``dr4sr_tpu/ops/topk.py::masked_topk_scores``: ``query @ item_emb.T``
over the whole catalog (``torch.matmul``; the JAX package left this product
to XLA), items outside ``item_keep_mask`` and items in ``user_hist`` masked
with booleans, then top-k.

``method="approx"`` maps to the exact top-k: ``lax.approx_max_k`` lowers to
an exact top-k on every backend but the TPU, and PyTorch has no
approximate top-k.

:func:`sharded_masked_topk` (``dr4sr_tpu/ops/topk.py:87-113``) is the
version for an item table row-sharded over the ``model`` axis: each rank
scores its rows and keeps its top min(k, N/S), the global ids are
all-gathered to [B, S·k], and the result is their top-k. Communication is
S·k candidates a query, not the [B, N] score row. Both top-k's of it sort
ties stably (index order, as ``lax.top_k``), so a tie across shards goes to
the lower id.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dr4sr_tpu_torch.parallel.collectives import Axis, all_gather

NEG = -1e30


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest along the last axis, equal values in index order (as
    ``lax.top_k``); ``torch.topk`` leaves the order of ties open."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _apply_masks(
    scores: torch.Tensor,  # [B, N]: items [offset, offset + N) of the catalog
    item_keep_mask: Optional[torch.Tensor],  # [N] True = eligible
    user_hist: Optional[torch.Tensor],  # [B, Lh] seen item ids (global)
    item_offset: int = 0,
) -> torch.Tensor:
    b, n = scores.shape
    if item_keep_mask is not None:
        scores = torch.where(item_keep_mask[None, :], scores, NEG)
    if user_hist is not None:
        # ids outside this slice land in a spare column that is dropped
        local = user_hist - item_offset
        in_range = (local >= 0) & (local < n)
        idx = torch.where(in_range, local, n).long()
        hit = torch.zeros((b, n + 1), dtype=torch.bool, device=scores.device)
        hit.scatter_(1, idx, True)
        scores = torch.where(hit[:, :n], NEG, scores)
    return scores


def masked_topk_scores(
    query: torch.Tensor,  # [B, D]
    item_emb: torch.Tensor,  # [N, D]
    k: int,
    item_keep_mask: Optional[torch.Tensor] = None,  # [N] True = eligible
    user_hist: Optional[torch.Tensor] = None,  # [B, Lh] seen item ids (0 = pad)
    method: str = "exact",  # "exact" | "approx" (both exact here)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores [B, k], topk_items [B, k])."""
    if method not in ("exact", "approx"):
        raise ValueError(f"unknown top-k method {method!r}")
    scores = torch.matmul(query.float(), item_emb.float().T)
    scores = _apply_masks(scores, item_keep_mask, user_hist)
    return torch.topk(scores, k, dim=-1)


def sharded_masked_topk(
    query: torch.Tensor,  # [B, D], the same on every rank of the axis
    item_emb_local: torch.Tensor,  # [N/S, D]: this rank's rows
    k: int,
    axis: Axis,  # the model axis the table is sharded over
    item_keep_mask_local: Optional[torch.Tensor] = None,  # [N/S]
    user_hist: Optional[torch.Tensor] = None,  # [B, Lh] global ids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, k], global item ids [B, k]) of the whole catalog, from
    each rank's top-k of its rows merged over ``axis``; every rank of the
    axis returns the same. Rows the keep mask drops (the table's padding)
    never surface."""
    nl = item_emb_local.shape[0]
    offset = axis.index * nl
    scores = torch.matmul(query.float(), item_emb_local.float().T)
    scores = _apply_masks(scores, item_keep_mask_local, user_hist, item_offset=offset)
    local_scores, local_idx = top_k_stable(scores, min(k, nl))
    all_scores = all_gather(local_scores, axis, dim=1)  # [B, S·k], shard-major
    all_ids = all_gather(local_idx + offset, axis, dim=1)
    top_scores, sel = top_k_stable(all_scores, k)
    return top_scores, torch.gather(all_ids, 1, sel)
