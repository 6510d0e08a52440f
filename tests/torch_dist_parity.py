"""JAX-side helpers of the port's distributed parity tests: SASRec steps
of the JAX ``Trainer`` under a ``MeshPlan`` on the virtual CPU devices, and
the same steps of the port on gloo ranks (``torch_dist_worker``), from the
JAX trainer's initial weights, batch and negatives."""

import copy

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_worker as w
from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.models.base import sample_negatives as jax_sample_negatives
from dr4sr_tpu.ops import ring_attention as jax_ring
from dr4sr_tpu.parallel import ep as jax_ep
from dr4sr_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dr4sr_tpu.parallel.mesh import create_mesh as jax_create_mesh
from dr4sr_tpu.train.trainer import Trainer as JaxTrainer
from dr4sr_tpu_torch.convert import params_from_jax
from dr4sr_tpu_torch.models import get_model_class

NUM_ITEMS = 61
BATCH = 32
STEPS = 3


def jax_steps(root, cfg, data=1, model=1, shard=False):
    """3 steps of the JAX trainer on its first batch with rng 3 each step:
    (initial params as the port's state_dict, host batch, negatives, losses,
    final params as the port's state_dict, validation metrics). The JAX
    trainer installs its EP and CP plans process-wide and leaves them; they
    are put back as they were, so that later tests in this process build
    their JAX models without a mesh."""
    prev = (jax_ep.get_plan(), jax_ring.get_context_plan())
    try:
        return _jax_steps(root, cfg, data, model, shard)
    finally:
        jax_ep.set_plan(prev[0])
        jax_ring.set_context_plan(*(prev[1] or (None,)))


def _jax_steps(root, cfg, data, model, shard):
    plan = None
    if data * model > 1:
        devices = jax.devices()[: data * model]
        plan = JaxMeshPlan(mesh=jax_create_mesh(data=data, model=model, devices=devices),
                           shard_embedding=shard)
    tr = JaxTrainer(copy.deepcopy(cfg), jax_prepare_datasets(copy.deepcopy(cfg), root=root),
                    mesh_plan=plan)
    tr.init_state(seed=7)
    module = get_model_class(cfg["model"]["model"]).build(cfg, NUM_ITEMS)

    def port(params):
        return {k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax.device_get(params)), module).items()}

    init = port(tr.state.params)
    batch = tr.train_data.get_loader(batch_size=BATCH, shuffle=False).sample_batch(BATCH)
    rng = jax.random.PRNGKey(3)
    # the negatives JAX's training_loss draws from this rng
    neg = np.asarray(jax_sample_negatives(jax.random.split(rng)[0],
                                          {"item_id": jnp.asarray(batch["item_id"])},
                                          NUM_ITEMS, cfg["data"]["max_seq_len"]))
    db = tr._device_batch(batch, is_train=True)
    losses = []
    for _ in range(STEPS):
        tr.state, loss = tr.train_step(tr.state, db, rng)
        losses.append(float(loss))
    table_rows = jax.device_get(tr.state.params)["item_embedding"]["embedding"].shape[0]
    metrics = tr._eval_epoch(tr.val_data, "syn", tr.state.params)
    return dict(init=init, batch=batch, neg=neg, losses=losses, params=port(tr.state.params),
                table_rows=table_rows, metrics=metrics)


def port_steps(tmp_path, setup, ref, data=1, model=1, shard=False):
    root, cfg = setup
    args = (cfg, root, data, model, shard, [ref["batch"]] * STEPS, [ref["neg"]] * STEPS,
            ref["init"], "syn")
    if data * model == 1:
        return [w.train_steps(0, *args)]
    return w.run_ranks(w.train_steps, data * model, tmp_path, *args)


def assert_params(got, want, atol=1e-5):
    for k, v in want.items():
        np.testing.assert_allclose(got[k][: v.shape[0]], v, atol=atol, err_msg=k)
