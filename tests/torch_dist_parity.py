"""JAX-side helpers of the port's distributed parity tests: steps of the
JAX ``Trainer`` under a ``MeshPlan`` on the virtual CPU devices, and the
same steps of the port on gloo ranks (``torch_dist_worker``), from the JAX
trainer's initial weights, batch and draws. The draws are the JAX
``_loss_fn``'s, reproduced from its key: the aux term's key splits off
first, then the contrastive term's, then the negatives' (``split(rng)[0]``
of what is left); the views and aux draws are the global batch's."""

import contextlib
import copy

import jax
import numpy as np

import torch
import torch_dist_worker as w
from torch_zoo_parity import jax_aug_draws

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.models.base import sample_negatives as jax_sample_negatives
from dr4sr_tpu.modules import augmentation as jax_aug
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


def jax_steps(root, cfg, data=1, model=1, shard=False, evaluate=True):
    """3 steps of the JAX trainer on its first batch with rng 3 each step:
    (initial params as the port's state_dict, host batch, negatives, views,
    aux draws, the per-epoch state of epoch 0, losses, final params as the
    port's state_dict, validation metrics unless ``evaluate`` is False).
    The JAX trainer installs its EP and CP plans process-wide and leaves
    them; they are put back as they were, so that later tests in this
    process build their JAX models without a mesh."""
    with jax_restoring_plans():
        return _jax_steps(root, cfg, data, model, shard, evaluate)


@contextlib.contextmanager
def jax_restoring_plans():
    """The JAX package's process-wide EP and CP plans put back as they were
    after the body (a JAX trainer on a mesh installs its own and leaves
    them)."""
    prev = (jax_ep.get_plan(), jax_ring.get_context_plan())
    try:
        yield
    finally:
        jax_ep.set_plan(prev[0])
        jax_ring.set_context_plan(*(prev[1] or (None,)))


def jax_draws(tr, db, rng):
    """The port's (negatives, views, aux draws) for the JAX trainer's
    ``_loss_fn(params, db, rng)``, all for the global batch ``db``."""
    m = tr.config["model"]
    r_aux = r_cl = None
    if getattr(tr.model_class, "aux_loss", None) is not None:
        rng, r_aux = jax.random.split(rng)
    if tr.contrastive:
        rng, r_cl = jax.random.split(rng)
    neg = np.asarray(jax_sample_negatives(jax.random.split(rng)[0], {"item_id": db["item_id"]},
                                          tr.num_items, tr.config["data"]["max_seq_len"]))
    views = None
    if r_cl is not None:
        r_i, r_j, _, _ = jax.random.split(r_cl, 4)
        seq, seqlen = db.get("aug_in_item_id", db["in_item_id"]), db.get("aug_seqlen",
                                                                          db["seqlen"])
        views = [tuple(np.asarray(a) for a in jax_aug.augment(
            r, seq, seqlen, m.get("augment_type", "item_random"), tao=m.get("tau", 0.2),
            gamma=m.get("gamma", 0.7), beta=m.get("beta", 0.2), mask_id=tr.num_items))
            for r in (r_i, r_j)]
    return neg, views, _aux_draws(tr, db, r_aux)


def _aux_draws(tr, db, r_aux):
    name, m = tr.config["model"]["model"], tr.config["model"]
    if name == "ICLRec":
        r_i, r_j, _, _ = jax.random.split(jax.random.split(r_aux)[0], 4)
        return [jax_aug_draws(m.get("augment_type", "item_random"), r, db["seqlen"],
                              tr.config["data"]["max_seq_len"]) for r in (r_i, r_j)]
    if name == "SGL":
        keep = 1.0 - float(m.get("ssl_ratio", 0.1))
        return [torch.from_numpy(np.array(jax.random.bernoulli(r, keep, db["edge_row"].shape)))
                for r in jax.random.split(r_aux)]
    if name == "SimGCL":
        shape = (tr.num_items, int(m["embed_dim"]))
        draws = []
        for key in jax.random.split(r_aux):
            layers = []
            for _ in range(int(m.get("gnn_layer", 2))):
                key, r = jax.random.split(key)
                layers.append(np.asarray(jax.random.uniform(r, shape)))
            draws.append(torch.from_numpy(np.stack(layers)))
        return draws
    return None


def _jax_steps(root, cfg, data, model, shard, evaluate):
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
    if tr.aug_from_original:  # CL4SRec2: the views' rows from another draw of the rows
        aug = tr.train_data.get_loader(batch_size=BATCH, seed=1).sample_batch(BATCH)
        batch = dict(batch, aug_in_item_id=aug["in_item_id"], aug_seqlen=aug["seqlen"],
                     aug_valid=aug["valid"])
    refresh = getattr(tr.model_class, "refresh_state", None)
    extras = {}
    if refresh is not None:
        extras = {k: np.asarray(v) for k, v in refresh(tr, 0).items()}
        tr.batch_extras.update(extras)
    rng = jax.random.PRNGKey(3)
    db = tr._device_batch(batch, is_train=True)
    neg, views, aux = jax_draws(tr, db, rng)
    losses = []
    for _ in range(STEPS):
        tr.state, loss = tr.train_step(tr.state, db, rng)
        losses.append(float(loss))
    table_rows = jax.device_get(tr.state.params)["item_embedding"]["embedding"].shape[0]
    metrics = tr._eval_epoch(tr.val_data, "syn", tr.state.params) if evaluate else None
    return dict(init=init, batch=batch, neg=neg, views=views, aux=aux, extras=extras,
                losses=losses, params=port(tr.state.params), table_rows=table_rows,
                metrics=metrics)


def jax_fused_steps(root, cfg, data=1, model=1, shard=False, n=4):
    """One group of ``n`` steps of the JAX trainer's ``multi_train_step`` on
    its first ``n`` batches of epoch 0, the step keys split from
    PRNGKey(3): (initial params as the port's state_dict, the host batches,
    each step's negatives, the losses, the final params as the port's)."""
    with jax_restoring_plans():
        plan = None
        if data * model > 1:
            plan = JaxMeshPlan(mesh=jax_create_mesh(data=data, model=model,
                                                    devices=jax.devices()[: data * model]),
                               shard_embedding=shard)
        tr = JaxTrainer(copy.deepcopy(cfg), jax_prepare_datasets(copy.deepcopy(cfg), root=root),
                        mesh_plan=plan)
        tr.init_state(seed=7)
        module = get_model_class(cfg["model"]["model"]).build(cfg, NUM_ITEMS)

        def port(params):
            return {k: v.numpy() for k, v in params_from_jax(
                jax.tree_util.tree_map(np.asarray, jax.device_get(params)), module).items()}

        init = port(tr.state.params)
        batches = list(tr.train_data.get_loader(seed=0))[:n]
        rngs = jax.random.split(jax.random.PRNGKey(3), n)
        draws = [(jax_draws(tr, tr._device_batch(b, is_train=True), r)[0],)
                 for b, r in zip(batches, rngs)]
        state, losses = tr.multi_train_step(tr.state, tr._device_batch_stack(batches), rngs,
                                            tr.batch_extras)
        return dict(init=init, batches=batches, draws=draws,
                    losses=np.asarray(losses).tolist(), params=port(state.params))


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
