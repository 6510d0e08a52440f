"""Helpers for the port's model-zoo parity tests: build a JAX model of the
zoo, carry its weights into the port's module, take the first train step's
loss and gradients on both sides from the same negatives (dropout 0), and
reproduce the draws of a JAX augmentation as the port's ``Draws``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dr4sr_tpu.data.synthetic import synthetic_config
from dr4sr_tpu.models.base import LOSS_FNS as JAX_LOSS_FNS
from dr4sr_tpu.models.base import RecModel as JaxRecModel
from dr4sr_tpu.models.base import item_table as jax_item_table
from dr4sr_tpu.models.base import pos_neg_scores as jax_pos_neg_scores
from dr4sr_tpu.models.registry import get_model_class as jax_model_class
from dr4sr_tpu_torch.convert import params_from_jax
from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.models.base import RecModel


def zoo_config(model, L, **model_cfg):
    config = synthetic_config(max_seq_len=L, model_name=model)
    config["model"].update({"embed_dim": 16, "hidden_size": 32, "head_num": 2, "layer_num": 2,
                            "dropout_rate": 0.0, **model_cfg})
    return config


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jax_rec_and_params(config, num_items, batch, seed=0):
    """The JAX RecModel and its initial params as numpy."""
    cls = jax_model_class(config["model"]["model"])
    rec = JaxRecModel(config, cls.build(config, num_items), num_items, 1)
    variables = rec.init(jax.random.PRNGKey(seed), to_jax(batch))
    return rec, jax.tree_util.tree_map(np.asarray, variables["params"])


def port_rec(config, num_items, params):
    """The port's RecModel with the JAX params carried over."""
    module = get_model_class(config["model"]["model"]).build(config, num_items)
    module.load_state_dict(params_from_jax(params, module))
    return RecModel(config, module, num_items, 1)


def jax_loss_and_grads(rec, params, batch, neg):
    """The main loss (no contrastive term) and its gradients, dropout off."""
    jbatch = to_jax(batch)

    def loss_fn(p):
        variables = {"params": p}
        query = rec.module.apply(variables, jbatch, training=True,
                                 rngs={"dropout": jax.random.PRNGKey(1)})
        pos, negs, mask = jax_pos_neg_scores(query, jax_item_table(variables), jbatch,
                                             jnp.asarray(neg))
        return JAX_LOSS_FNS[rec.config["model"].get("loss_fn", "bce")](pos, negs, mask)

    loss, grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def assert_grads_match(module, jax_grads, atol):
    """Every parameter's gradient against the JAX gradient tree, carried
    over by the same rules as the weights."""
    want = params_from_jax(jax_grads, module)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=atol, err_msg=name)


def jax_aug_draws(kind, key, seqlen, l, tao=0.2, beta=0.2):
    """The port's draws for one call of JAX's ``augment(key, ..., kind)``."""
    seqlen = jnp.asarray(seqlen)
    b = seqlen.shape[0]
    if kind == "item_random":
        r_pick, key = jax.random.split(key)
        kind = ("item_crop", "item_mask", "item_reorder")[int(jax.random.randint(r_pick, (), 0, 3))]

    def start(k, sub_len):
        return jax.random.randint(k, seqlen.shape, 0, jnp.maximum(seqlen - sub_len + 1, 1))

    s = u = None
    if kind == "item_crop":
        s = start(key, jnp.maximum(1, (tao * seqlen).astype(jnp.int32)))
    elif kind == "item_mask":
        u = jax.random.uniform(key, (b, l))
    else:
        r_start, r_perm = jax.random.split(key)
        s = start(r_start, (beta * seqlen).astype(jnp.int32))
        u = jax.random.uniform(r_perm, (b, l))
    return {"kind": kind,
            "start": None if s is None else torch.tensor(np.asarray(s)).long(),
            "u": None if u is None else torch.tensor(np.asarray(u))}


def assert_topk_match(got_items, got_scores, want_items, want_scores, atol):
    """Scores within ``atol``; items equal wherever a score is apart from
    both its neighbours by more than ``atol`` (near ties may swap)."""
    want_items, want_scores = np.asarray(want_items), np.asarray(want_scores)
    np.testing.assert_allclose(got_scores, want_scores, atol=atol)
    apart = np.abs(np.diff(want_scores, axis=1)) > atol
    sep = np.ones(want_scores.shape, bool)
    sep[:, 1:] &= apart
    sep[:, :-1] &= apart
    sep[:, -1] = False
    np.testing.assert_array_equal(got_items[sep], want_items[sep])
