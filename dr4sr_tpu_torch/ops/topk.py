"""Full-catalog scoring + masked top-k — the eval and serving hot path.

Port of ``dr4sr_tpu/ops/topk.py::masked_topk_scores``: ``query @ item_emb.T``
over the whole catalog (``torch.matmul``; the JAX package left this product
to XLA), items outside ``item_keep_mask`` and items in ``user_hist`` masked
with booleans, then top-k.

``method="approx"`` maps to the exact top-k: ``lax.approx_max_k`` lowers to
an exact top-k on every backend but the TPU, and PyTorch has no
approximate top-k. The sharded top-k waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = -1e30


def _apply_masks(
    scores: torch.Tensor,  # [B, N]
    item_keep_mask: Optional[torch.Tensor],  # [N] True = eligible
    user_hist: Optional[torch.Tensor],  # [B, Lh] seen item ids
) -> torch.Tensor:
    b, n = scores.shape
    if item_keep_mask is not None:
        scores = torch.where(item_keep_mask[None, :], scores, NEG)
    if user_hist is not None:
        # ids outside [0, N) land in a spare column that is dropped
        in_range = (user_hist >= 0) & (user_hist < n)
        idx = torch.where(in_range, user_hist, n).long()
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
