"""Ranking metrics on torch tensors.

Port of the rank metrics of ``dr4sr_tpu/evaluation/__init__.py``, with the
reference's contract (``evaluation/__init__.py``): each metric consumes
``pred`` — a boolean [B, topk] hit matrix where column j says "the j-th
ranked item is a true target" — plus ``target`` ([B] or [B, T] positive
ratings) and a cutoff, and returns the **per-sample** [B] vector. The
trainer aggregates with the batch ``valid`` mask, which reproduces the
reference's ``Σ metric·bs / Σ bs``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch


def _target_count(target: torch.Tensor) -> torch.Tensor:
    if target.dim() == 1:
        target = target[:, None]
    return (target > 0).sum(dim=-1)


def recall(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    count = _target_count(target).clamp_min(1)
    return pred[:, :k].sum(dim=-1).float() / count


def precision(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    return pred[:, :k].sum(dim=-1).float() / k


def f1(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    count = _target_count(target)
    return 2.0 * pred[:, :k].sum(dim=-1).float() / (count + k)


def _dcg(pred: torch.Tensor, k: int) -> torch.Tensor:
    k = min(k, pred.shape[1])
    denom = torch.log2(torch.arange(k, dtype=torch.float32, device=pred.device) + 2.0)[None, :]
    return (pred[:, :k].float() / denom).sum(dim=-1)


def ndcg(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    if target.dim() == 1:
        target = target[:, None]
    rel = torch.sort((target > 0).float(), dim=-1, descending=True).values
    ideal = _dcg(rel, k)
    all_irrelevant = (target <= 1e-9).all(dim=-1)
    return torch.where(all_irrelevant, 0.0, _dcg(pred, k) / ideal.clamp_min(1e-12))


def mrr(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    hits = pred[:, :k]
    ranks = torch.arange(1, hits.shape[1] + 1, dtype=torch.float32, device=pred.device)[None, :]
    first = torch.where(hits, ranks, torch.inf).amin(dim=-1)
    return torch.where(torch.isinf(first), 0.0, 1.0 / first)


def hit(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    return pred[:, :k].any(dim=-1).float()


def map_(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    count = _target_count(target)
    p = pred[:, :k].float()
    cum = p.cumsum(dim=-1) / torch.arange(1, k + 1, dtype=torch.float32, device=pred.device)[None, :]
    return (cum * p).sum(dim=-1) / count.clamp_max(k)


MetricFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]

metric_dict: Dict[str, MetricFn] = {
    "ndcg": ndcg,
    "recall": recall,
    "precision": precision,
    "f1": f1,
    "mrr": mrr,
    "hit": hit,
    "map": map_,
}


def compute_rank_metrics(
    pred: torch.Tensor,  # [B, topk] bool
    target: torch.Tensor,  # [B] positive ratings (label column)
    metric_names: Sequence[str],
    cutoffs: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """Per-sample values for every name@cutoff pair (names that are not rank
    metrics are skipped, as in the JAX package)."""
    out = {}
    for c in cutoffs:
        for m in metric_names:
            if m in metric_dict:
                out[f"{m}@{c}"] = metric_dict[m](pred, target, int(c))
    return out
