"""The multi-device layer: the ``data`` × ``model`` mesh over ``torch.distributed``
(:mod:`.mesh`), collectives with the gradients the JAX package's autodiff
gives (:mod:`.collectives`) and the row-sharded item-table gathers
(:mod:`.ep`)."""

from dr4sr_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshPlan,
    create_mesh,
    init_distributed,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
)
