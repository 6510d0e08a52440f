"""ICLRec — intent-contrastive sequential recommendation.

Port of ``dr4sr_tpu/models/iclrec.py`` (reference ``ICLRecAugmentation``,
``module/data_augmentation.py:671-745``): a SASRec backbone plus

* an instance term: InfoNCE between two augmented views of each sequence;
* an intent term: each view against the k-means centroid nearest to the
  row's mean-pooled representation, rows of the same intent not counted
  as each other's negatives.

The centroids are fitted at the start of every epoch (``refresh_state``)
over the mean-pooled eval-mode representations of every train row, and
ride in the batches as ``intent_centroids``. A step encodes the batch four
times: the main loss, the pooled representation that picks each row's
intent (no gradient: it feeds only an argmin), and the two views.

As CL4SRec, the item table has one extra row, the mask token ``num_items``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from dr4sr_tpu_torch.models.registry import register_model
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.modules.augmentation import sample_draws
from dr4sr_tpu_torch.modules.graph_augmentation import (
    KMeansState,
    iclrec_cl_losses,
    kmeans,
    kmeans_init,
)
from dr4sr_tpu_torch.modules.layers import seq_pooling

Batch = Dict[str, torch.Tensor]


def _mean_rep(module, seq: torch.Tensor, seqlen: torch.Tensor) -> torch.Tensor:
    """[B, D] the encoder's outputs averaged over each row's length."""
    return seq_pooling(module({"in_item_id": seq, "seqlen": seqlen}, need_pooling=False),
                       seqlen, "mean")


@register_model("ICLRec")
class ICLRec(SASRec):
    @staticmethod
    def build(config: Dict[str, Any], num_items: int, **kwargs):
        return SASRec.build(config, num_items, extra_embedding_rows=1, **kwargs)

    @staticmethod
    @torch.no_grad()
    def pooled_train_reps(trainer) -> torch.Tensor:
        """[N, D] the mean-pooled representations of the train rows, in
        order (the unshuffled loader, padded rows left out), eval mode."""
        module = trainer.rec.module
        was_training = module.training
        module.eval()
        reps = []
        try:
            for batch in trainer.train_data.get_loader(shuffle=False):
                b = trainer.device_batch(batch, is_train=True)
                reps.append(_mean_rep(module, b["in_item_id"], b["seqlen"])[b["valid"]])
        finally:
            module.train(was_training)
        return torch.cat(reps)

    @staticmethod
    def refresh_state(trainer, nepoch: int) -> Dict[str, torch.Tensor]:
        """The E-step: k-means intent prototypes (``num_intent_clusters``)
        of :meth:`pooled_train_reps` under the current weights."""
        reps = ICLRec.pooled_train_reps(trainer)
        k = int(trainer.config["model"].get("num_intent_clusters", 32))
        cents, _ = kmeans(reps, k, kmeans_init(reps.shape[0], k, nepoch))
        return {"intent_centroids": cents}

    @staticmethod
    def aux_draws(generator: Optional[torch.Generator], batch: Batch, model_cfg,
                  num_items: int):
        """The two views' augmentation draws (``augment_type``, at the
        augmentations' default ratios, as the JAX package's ``augment`` call)."""
        kind = model_cfg.get("augment_type", "item_random")
        return [sample_draws(generator, batch["in_item_id"], batch["seqlen"], kind)
                for _ in range(2)]

    @staticmethod
    def aux_loss(module, batch: Batch, model_cfg, num_items: int, draws):
        seq, seqlen = batch["in_item_id"], batch["seqlen"]
        with torch.no_grad():
            pooled = _mean_rep(module, seq, seqlen)
        out = iclrec_cl_losses(
            lambda s, n: module({"in_item_id": s, "seqlen": n}, need_pooling=False),
            seq, seqlen, pooled, KMeansState(batch["intent_centroids"], None), num_items,
            draws, temperature=float(model_cfg.get("temperature", 1.0)),
            valid=batch.get("valid"))
        return (float(model_cfg.get("instance_weight", 0.1)) * out["instance_cl_loss"]
                + float(model_cfg.get("intent_weight", 0.1)) * out["intent_cl_loss"])
