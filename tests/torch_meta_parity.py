"""JAX-side helpers of the bilevel trainer's parity tests: the JAX
``MetaTrainer``'s draws reproduced from its keys as the port takes them,
its meta parameters as the port's, and the closeness rule of the
hypergradient. In ``_weighted_loss`` ``rng_loss, rng_gumbel = split(rng)``
(a contrastive sub-model then splits ``rng_cl`` off ``rng_loss``), the
negatives come from ``split(rng_loss)[0]``; in ``outer_step`` ``r_val,
r_train = split(rng)``."""

import os

import jax
import numpy as np
import torch

from dr4sr_tpu.models.base import sample_negatives as jax_sample_negatives
from dr4sr_tpu.modules import augmentation as jax_aug
from dr4sr_tpu_torch.convert import meta_params_from_jax

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs")


def t(x):
    return torch.tensor(np.asarray(x))


def logits_shape(batch):
    """The meta MLP's output: [B, L, 2] for a per-position query, else [B, 2]."""
    return batch["item_id"].shape + (2,)


def weighted_draws(jax_tr, jbatch, key):
    """The port's (neg_id, views, noise) for JAX's ``_weighted_loss(..., key)``."""
    n, length = jax_tr.num_items, int(jax_tr.config["data"]["max_seq_len"])
    rng_loss, rng_gumbel = jax.random.split(key)
    views = None
    if jax_tr.contrastive:
        rng_loss, rng_cl = jax.random.split(rng_loss)
        m = jax_tr.config["model"]
        r_i, r_j, _, _ = jax.random.split(rng_cl, 4)
        views = [tuple(t(a).long() for a in jax_aug.augment(
            r, jbatch["in_item_id"], jbatch["seqlen"], m["augment_type"], tao=m["tau"],
            gamma=m["gamma"], beta=m["beta"], mask_id=n)) for r in (r_i, r_j)]
    r_neg, _ = jax.random.split(rng_loss)
    neg = jax_sample_negatives(r_neg, jbatch, n, length)
    return t(neg).long(), views, t(jax.random.gumbel(rng_gumbel, logits_shape(jbatch)))


def outer_draws(jax_tr, jval, jtrain, key):
    """The port's (val_neg, train_neg, noise) for JAX's ``outer_step(..., key)``."""
    r_val, r_train = jax.random.split(key)
    train_neg, _, noise = weighted_draws(jax_tr, jtrain, r_train)
    val_neg = jax_sample_negatives(jax.random.split(r_val)[0], jval, jax_tr.num_items,
                                   int(jax_tr.config["data"]["max_seq_len"]))
    return t(val_neg).long(), train_neg, noise


def jax_meta_as_port(tree, module):
    """A JAX meta tree ({"mlp", "tau"}) as the port's meta parameters."""
    state, tau = meta_params_from_jax(jax.tree_util.tree_map(np.asarray, tree), module)
    return {**state, "tau": torch.tensor(tau)}


def assert_close_to_largest(got, want, rtol, what):
    """Each tensor's largest error within ``rtol`` of its largest element."""
    for k, w in want.items():
        err = (got[k].detach() - w).abs().max().item()
        assert err <= rtol * max(w.abs().max().item(), 1e-30), f"{what} {k}: {err}"
