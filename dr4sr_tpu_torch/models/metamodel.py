"""MetaModel (DR4SR+) — bilevel per-sample reweighting around any sub-model.

Port of ``dr4sr_tpu/models/metamodel.py``. Behavioural spec, from the
reference ``model/metamodel.py``:

* the sub-model is built from its own layered config (``sub_model`` key);
* meta-net = MLP(D → D → 2) over the per-position query, and a learnable
  temperature τ (init 10, clipped below at ``tau_min``); per-position
  weight = ``gumbel_softmax(meta(query), τ)[..., 0]``;
* weights are forced to 1 on pattern rows (user_id == 0) and 0 on padding;
  inner loss = Σ weight · per-position loss;
* plain sub-model steps during ``warmup_epoch`` epochs, weighted steps
  after; every ``interval`` steps an outer step: the implicit hypergradient
  of an unweighted val-proxy batch loss with respect to the meta
  parameters (3-term Neumann series), clipped to global norm 10, then
  SGD (momentum 0.9) or Adam on the meta parameters.

The trainer is :class:`dr4sr_tpu_torch.train.meta_trainer.MetaTrainer`;
``quickstart.make_trainer`` picks it for a config whose model is MetaModel.
"""

from __future__ import annotations

from typing import Optional

import torch

from dr4sr_tpu_torch.models.registry import register_model


@register_model("MetaModel")
class MetaModel:
    is_meta = True

    @staticmethod
    def build(config, num_items, **kwargs):
        raise RuntimeError("MetaModel is a trainer wrapper; use MetaTrainer")


def gumbel_softmax_weight(
    logits: torch.Tensor, tau: torch.Tensor, noise: Optional[torch.Tensor]
) -> torch.Tensor:
    """softmax((logits + noise)/τ)[..., 0] (torch ``F.gumbel_softmax`` with
    hard=False); ``noise`` is standard Gumbel draws of the logits' shape, or
    None for none."""
    if noise is not None:
        logits = logits + noise
    return torch.softmax(logits / tau, dim=-1)[..., 0]
