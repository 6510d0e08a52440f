"""The trainer factory (counterpart of ``dr4sr_tpu/quickstart.py::make_trainer``).

``quickstart.run`` and ``quickstart.tune`` of the JAX package are not
ported yet; ``python -m dr4sr_tpu_torch.run`` is the one-call entry.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from dr4sr_tpu_torch.data.dataset import SeqDataset
from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.parallel.mesh import MeshPlan
from dr4sr_tpu_torch.train.trainer import Trainer


def make_trainer(config: Dict[str, Any], datasets: Tuple[SeqDataset, SeqDataset, SeqDataset],
                 workdir: Optional[str] = None, device="cuda",
                 mesh_plan: Optional[MeshPlan] = None) -> Trainer:
    """A ``MetaTrainer`` for a bilevel model (``is_meta``: MetaModel), else a
    ``Trainer``; on ``device`` (the card unless the caller asks otherwise),
    over ``mesh_plan``'s ranks when one is given."""
    if getattr(get_model_class(config["model"]["model"]), "is_meta", False):
        from dr4sr_tpu_torch.train.meta_trainer import MetaTrainer

        return MetaTrainer(config, datasets, workdir=workdir, device=device,
                           mesh_plan=mesh_plan)
    return Trainer(config, datasets, workdir=workdir, device=device, mesh_plan=mesh_plan)
