"""Device mesh and sharding plan over ``torch.distributed``.

Port of ``dr4sr_tpu/parallel/mesh.py``. One process is one rank, and one
rank one device. The mesh has two axes,
``init_device_mesh(device_type, (data, model), mesh_dim_names=("data",
"model"))``, with rank = data index · model + model index:

* ``data`` — the batch (DP). Every rank builds the same global host batch,
  as the JAX package's loaders do on every host, and keeps its own rows
  (:func:`shard_batch`). JAX's loss mean contracts over the sharded batch
  axis under ``jit``; here each rank's loss is its own numerator over the
  global batch's count (``modules/losses.py``), and the trainer sums the
  gradients over the ``data`` group, so W ranks take the global batch's
  gradient.
* ``model`` — catalog rows (EP: the item table row-sharded, ``parallel/
  ep.py``, and the sharded eval top-k, ``ops/topk.py``) and sequence chunks
  (CP: ``ops/ring_attention.py``). Every rank of a ``model`` group holds
  the same batch rows.

The process group's backend is NCCL on the card and gloo on the CPU
(:func:`init_distributed`); several ranks that share one card take gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from dr4sr_tpu_torch.parallel.collectives import LOCAL, Axis, broadcast_

DATA_AXIS = "data"
MODEL_AXIS = "model"
# every process group and collective of the port fails after this long
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(backend: Optional[str] = None, store: Optional[dist.Store] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the default process group, once (idempotent). Without ``store``
    it reads torchrun's ``env://`` (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); with one (e.g. a ``FileStore``) it
    takes ``rank`` and ``world_size`` as given. ``backend`` defaults to
    NCCL when CUDA is available, else gloo."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if store is None:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timeout)


def process_index() -> int:
    """This process's rank in the default group (0 without one): process 0
    alone writes checkpoints and logs."""
    return dist.get_rank() if dist.is_initialized() else 0


def create_mesh(data: Optional[int] = None, model: int = 1,
                device_type: Optional[str] = None):
    """The ``data`` × ``model`` ``DeviceMesh`` over every rank of the default
    group (``data`` defaults to world size / ``model``). ``device_type``
    defaults to ``cuda`` when CUDA is available, else ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, not {world}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


@dataclasses.dataclass
class MeshPlan:
    """Sharding plan bound to a mesh (or None: one device)."""

    mesh: Optional[object] = None  # a DeviceMesh with axes ("data", "model")
    shard_embedding: bool = False  # row-shard the item table over MODEL_AXIS

    def axis(self, name: str) -> Axis:
        """This rank's view of the mesh axis ``name`` (:data:`LOCAL` without
        a mesh)."""
        if self.mesh is None:
            return dataclasses.replace(LOCAL, name=name)
        group = self.mesh.get_group(name)
        return Axis(name, group, self.mesh.size(self.mesh.mesh_dim_names.index(name)),
                    self.mesh.get_local_rank(name),
                    tuple(dist.get_process_group_ranks(group)))

    @property
    def data_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size(0)

    @property
    def model_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size(1)

    @property
    def world(self) -> Axis:
        """Every rank of the mesh, as one axis named ``world``."""
        if self.mesh is None:
            return dataclasses.replace(LOCAL, name="world")
        group = dist.group.WORLD
        return Axis("world", group, dist.get_world_size(), dist.get_rank(),
                    tuple(range(dist.get_world_size())))

    def ep_sharded(self) -> bool:
        """Whether the item table is row-sharded (EP over > 1 model ranks)."""
        return self.shard_embedding and self.model_size > 1

    def row_slice(self, n_rows: int) -> slice:
        """This rank's contiguous rows of a table of ``n_rows`` (a multiple of
        the model axis) under EP."""
        m = self.axis(MODEL_AXIS)
        return slice(m.index * n_rows // m.size, (m.index + 1) * n_rows // m.size)


def pad_batch_to_multiple(batch: Dict[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Pad the leading axis so it divides ``multiple`` (padded rows are
    ``valid=False``)."""
    b = len(next(iter(batch.values())))
    rem = (-b) % multiple
    if rem == 0:
        return batch
    out = {k: np.pad(v, [(0, rem)] + [(0, 0)] * (np.ndim(v) - 1)) for k, v in batch.items()}
    valid = batch.get("valid", np.ones(b, bool))
    out["valid"] = np.concatenate([valid, np.zeros(rem, bool)])
    return out


def shard_batch(batch: Dict[str, np.ndarray], plan: MeshPlan) -> Dict[str, np.ndarray]:
    """This rank's rows of a global host batch whose leading axis the
    ``data`` axis divides (:func:`pad_batch_to_multiple`)."""
    if plan.data_size == 1:
        return batch
    data = plan.axis(DATA_AXIS)
    out = {}
    for k, v in batch.items():
        if len(v) % data.size:
            raise ValueError(f"batch[{k!r}] has {len(v)} rows, not a multiple of {data.size}")
        per = len(v) // data.size
        out[k] = v[data.index * per:(data.index + 1) * per]
    return out


def replicate(tensors: Iterable[torch.Tensor], plan: MeshPlan) -> None:
    """Every rank takes global rank 0's values of ``tensors``, in place."""
    world = plan.world
    with torch.no_grad():
        for t in tensors:
            broadcast_(t, world)
