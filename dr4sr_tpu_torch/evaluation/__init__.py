"""Ranking and prediction metrics on torch tensors.

Port of ``dr4sr_tpu/evaluation/__init__.py``, with the
reference's contract (``evaluation/__init__.py``): each metric consumes
``pred`` — a boolean [B, topk] hit matrix where column j says "the j-th
ranked item is a true target" — plus ``target`` ([B] or [B, T] positive
ratings) and a cutoff, and returns the **per-sample** [B] vector. The
trainer aggregates with the batch ``valid`` mask, which reproduces the
reference's ``Σ metric·bs / Σ bs``. The prediction metrics take scores
and targets and take no cutoff; ``auc`` returns one global value.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

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


# ---------------------------------------------------------------------------
# prediction metrics (reference ``evaluation/__init__.py:174-232``)
# ---------------------------------------------------------------------------


def logloss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample binary cross-entropy with logits."""
    t = target.float()
    return pred.clamp_min(0) - pred * t + torch.log1p(torch.exp(-pred.abs()))


def accuracy(pred: torch.Tensor, target: torch.Tensor, thres: float = 0.5) -> torch.Tensor:
    return ((pred >= thres) == (target > 0.5)).float()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target) ** 2


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs()


def auc(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Global AUC via rank statistic (Mann-Whitney U); returns a scalar.
    Tied scores keep their order (a stable sort, as ``jnp.argsort``), so a
    tie is not averaged."""
    order = torch.argsort(pred, stable=True)
    ranks = torch.argsort(order, stable=True).float() + 1.0
    pos = target > 0.5
    n_pos = pos.sum()
    n_neg = pred.shape[0] - n_pos
    u = torch.where(pos, ranks, 0.0).sum() - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg).float().clamp_min(1.0)


MetricFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]

metric_dict: Dict[str, Callable] = {
    "ndcg": ndcg,
    "recall": recall,
    "precision": precision,
    "f1": f1,
    "mrr": mrr,
    "hit": hit,
    "map": map_,
    "logloss": logloss,
    "accuracy": accuracy,
    "mse": mse,
    "mae": mae,
    "auc": auc,
}

_TOPK_METRICS = {"ndcg", "recall", "precision", "f1", "mrr", "hit", "map"}
_PRED_METRICS = {"logloss", "accuracy", "mse", "mae", "auc"}


def get_pred_metrics(metrics: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(metrics, str):
        metrics = [metrics]
    return [m for m in metrics if m in _PRED_METRICS]


def get_rank_metrics(metrics: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(metrics, str):
        metrics = [metrics]
    return [m for m in metrics if m in _TOPK_METRICS]


def get_eval_metrics(
    metric_names: Union[str, Sequence[str]],
    cutoffs: Union[int, Sequence[int]],
    validation: bool = False,
) -> List[str]:
    """Expand names × cutoffs into 'name@cutoff' keys
    (reference ``get_eval_metrics``; validation keeps only the first cutoff)."""
    if isinstance(metric_names, str):
        metric_names = [metric_names]
    if not isinstance(cutoffs, (list, tuple)):
        cutoffs = [cutoffs]
    if validation:
        cutoffs = list(cutoffs)[:1]
    return [f"{m}@{c}" for c in cutoffs for m in metric_names if m in _TOPK_METRICS]


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
            if m in _TOPK_METRICS:  # pred metrics don't take a cutoff
                out[f"{m}@{c}"] = metric_dict[m](pred, target, int(c))
    return out
