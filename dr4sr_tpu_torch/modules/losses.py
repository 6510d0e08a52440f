"""Ranking losses with the reference's padding semantics.

Port of ``dr4sr_tpu/modules/losses.py:28-101``. The reference marks padded
positions with ``-inf`` positive scores; here every loss takes an explicit
boolean ``mask`` (True = real position) and reproduces the same numerics:

* BCE: ``-Σ logσ(pos)/M + Σ mean_neg softplus(neg)/M`` with ``M`` the number
  of unmasked positions; ``reduce=False`` returns the per-position
  contribution divided by ``M`` (the bilevel reweighter's input).
* BPR: ``-Σ mean_neg logσ(pos-neg)/M``.
* :func:`alignment` and :func:`uniformity` of normalized representations.
* :func:`info_nce_loss` (``:104-151``), CL4SRec's in-batch InfoNCE.

The loss arithmetic is f32 whatever the scores' dtype (bf16 under autocast).
Masked logits are −1e30, not −inf, as in the JAX package: a row whose every
logit is masked stays finite.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG = -1e30


def binary_cross_entropy_loss(
    pos_score: torch.Tensor,  # [B] or [B, L]
    neg_score: torch.Tensor,  # [B, neg] or [B, L, neg]
    mask: torch.Tensor,  # bool, same shape as pos_score; True = real
    reduce: bool = True,
) -> torch.Tensor:
    pos_score = pos_score.float()
    neg_score = neg_score.float()
    mask_f = mask.float()
    denom = mask_f.sum().clamp_min(1.0)
    pos_loss = F.logsigmoid(pos_score) * mask_f
    neg_loss = F.softplus(neg_score).mean(dim=-1)
    if pos_score.dim() == neg_score.dim() - 1:
        # per-position negatives share the positive's mask
        neg_loss = neg_loss * mask_f
        if reduce:
            return (-pos_loss.sum() + neg_loss.sum()) / denom
        return (-pos_loss + neg_loss) / denom
    # batch-level negatives: the reference takes a plain mean over them
    neg_term = neg_loss.mean()
    if reduce:
        return -pos_loss.sum() / denom + neg_term
    return -pos_loss / denom + neg_term / pos_loss.numel()


def bpr_loss(
    pos_score: torch.Tensor,
    neg_score: torch.Tensor,
    mask: torch.Tensor,
    reduce: bool = True,
) -> torch.Tensor:
    pos_score = pos_score.float()
    neg_score = neg_score.float()
    mask_f = mask.float()
    denom = mask_f.sum().clamp_min(1.0)
    loss = F.logsigmoid(pos_score[..., None] - neg_score).mean(dim=-1) * mask_f
    if reduce:
        return -loss.sum() / denom
    return -loss / denom


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def alignment(x: torch.Tensor, y: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared distance of L2-normalized pairs (reference
    ``SASRec.alignment``, ``model/sasrec.py:100-102``)."""
    d2 = ((_normalize(x) - _normalize(y)) ** 2).sum(dim=-1)
    if valid is not None:
        return torch.where(valid, d2, 0.0).sum() / valid.sum().clamp_min(1)
    return d2.mean()


def uniformity(x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log-mean-exp(-2·pairwise-distance²) over normalized reps (reference
    ``SASRec.uniformity``): the full pairwise matrix minus the diagonal."""
    nx = _normalize(x)
    d2 = ((nx[:, None] - nx[None, :]) ** 2).sum(dim=-1)  # [N, N]
    off = ~torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    if valid is not None:
        off = off & valid[:, None] & valid[None, :]
    w = off.float()
    return torch.log((torch.exp(-2.0 * d2) * w).sum() / w.sum().clamp_min(1.0))


def info_nce_loss(
    rep_i: torch.Tensor,  # [B, D]
    rep_j: torch.Tensor,  # [B, D]
    temperature: float = 1.0,
    sim_method: str = "inner_product",
    instance_labels: Optional[torch.Tensor] = None,  # [B]
    valid: Optional[torch.Tensor] = None,  # [B] bool; False rows contribute 0
    reduce: bool = True,
    neg_type: str = "batch_both",
) -> torch.Tensor:
    """In-batch InfoNCE. ``batch_both``: logits [sim_ij | sim_ii] (2B − 1
    negatives) with self (and same-label pairs) masked; ``batch_single``:
    sim_ij only (B − 1 negatives). The label is the row's own column of
    sim_ij. Rows with ``valid`` False neither count nor act as negatives."""
    rep_i, rep_j = rep_i.float(), rep_j.float()
    b = rep_i.shape[0]
    if sim_method == "cosine":
        rep_i, rep_j = _normalize(rep_i), _normalize(rep_j)
    sim_ii = rep_i @ rep_i.T / temperature
    sim_ij = rep_i @ rep_j.T / temperature
    eye = torch.eye(b, dtype=torch.bool, device=rep_i.device)
    if instance_labels is not None:
        same = instance_labels[:, None] == instance_labels[None, :]
        sim_ii = sim_ii.masked_fill(same, _NEG)
        sim_ij = sim_ij.masked_fill(same & ~eye, _NEG)
    else:
        sim_ii = sim_ii.masked_fill(eye, _NEG)
    if valid is not None:
        col_pad = ~valid[None, :]
        sim_ii = sim_ii.masked_fill(col_pad, _NEG)
        sim_ij = sim_ij.masked_fill(col_pad & ~eye, _NEG)
    logits = sim_ij if neg_type == "batch_single" else torch.cat([sim_ij, sim_ii], dim=-1)
    per_row = -torch.diagonal(F.log_softmax(logits, dim=-1))
    if valid is not None:
        per_row = torch.where(valid, per_row, 0.0)
        count = valid.float().sum().clamp_min(1.0)
    else:
        count = float(b)
    return per_row.sum() / count if reduce else per_row / count
