"""CL4SRec — SASRec plus a contrastive term over augmented views.

Port of ``dr4sr_tpu/models/cl4srec.py``. Each train step encodes two
stochastic augmentations of the batch's sequences (no pooling, then a mean
over each view's length), and adds ``cl_weight`` × an InfoNCE
(``batch_both``: 2B − 1 in-batch negatives) to the main loss; rows of
length 1 and the padded rows of the last batch are left out of it. So a
step runs the SASRec encoder, and both attention kernels, three times. The
item table has one extra row, the mask token ``num_items``: real data, not
padding, so the encoder's key-padding mask (``seq == 0``) leaves it
attended; negatives and eval never reach it.

``CL4SRec2`` draws the augmentation batch from the original train rows
while the main loss reads the regenerated ones (the trainer's second
loader).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from dr4sr_tpu_torch.models.registry import register_model
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.modules.augmentation import augment
from dr4sr_tpu_torch.modules.layers import seq_pooling
from dr4sr_tpu_torch.modules.losses import info_nce_loss
from dr4sr_tpu_torch.parallel.collectives import Axis

View = Tuple[torch.Tensor, torch.Tensor]  # (seq [B, L], seqlen [B])


def augment_views(generator: Optional[torch.Generator], seq: torch.Tensor,
                  seqlen: torch.Tensor, model_cfg: Dict[str, Any],
                  num_items: int, axis: Optional[Axis] = None) -> Tuple[View, View]:
    """Two independent views of the batch, as ``model_cfg`` configures them
    (``augment_type``, ``tau``, ``gamma``, ``beta``; mask id ``num_items``);
    given the data axis, this rank's rows of the global batch's views."""
    kw = dict(kind=model_cfg.get("augment_type", "item_random"),
              tao=float(model_cfg.get("tau", 0.2)), gamma=float(model_cfg.get("gamma", 0.7)),
              beta=float(model_cfg.get("beta", 0.2)), mask_id=num_items, axis=axis)
    return augment(generator, seq, seqlen, **kw), augment(generator, seq, seqlen, **kw)


def cl_loss(
    module: nn.Module,
    seq: torch.Tensor,
    seqlen: torch.Tensor,
    valid: torch.Tensor,
    model_cfg: Dict[str, Any],
    num_items: int,
    generator: Optional[torch.Generator] = None,
    views: Optional[Sequence[View]] = None,
    reduce: bool = True,
    axis: Optional[Axis] = None,
    global_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The contrastive term: two augmented views → the encoder in train
    mode → mean-pooled reps → InfoNCE over the rows with ``seqlen > 1`` and
    ``valid``. ``views`` gives the two views instead of drawing them from
    ``generator``.

    Under data parallelism (``axis``, the data axis) ``seq``, ``seqlen``,
    ``valid`` and ``views`` are this rank's rows; the views are drawn for
    the global batch in lockstep and cut to them; ``global_mask`` is the
    global batch's ``seqlen > 1`` and ``valid`` [b · W], which every rank
    has from the host batch; the InfoNCE scores this rank's rows against
    the views gathered over the axis (``losses.info_nce_loss``)."""
    if views is None:
        views = augment_views(generator, seq, seqlen, model_cfg, num_items, axis)
    module.train()
    reps = [seq_pooling(module({"in_item_id": s, "seqlen": n}, need_pooling=False), n, "mean")
            for s, n in views]
    if axis is None:
        global_mask = (seqlen > 1) & valid
    return info_nce_loss(reps[0], reps[1], temperature=float(model_cfg.get("temperature", 1.0)),
                         valid=global_mask, reduce=reduce, axis=axis)


@register_model("CL4SRec")
class CL4SRec(SASRec):
    contrastive = True
    aug_from_original = False

    @staticmethod
    def build(config: Dict[str, Any], num_items: int, **kwargs) -> nn.Module:
        return SASRec.build(config, num_items, extra_embedding_rows=1, **kwargs)


@register_model("CL4SRec2")
class CL4SRec2(CL4SRec):
    aug_from_original = True
