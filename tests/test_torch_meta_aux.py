"""DR4SR+ (``MetaTrainer``) around a sub-model with an ``aux_loss``, held
against the JAX ``MetaTrainer`` on the CPU (one device, D 16, 1 layer,
L 10, batch 16, dropout 0), from the JAX trainer's weights and its draws.

* SGL and SimGCL: a warm step (the plain step: the aux term is in, its
  edge masks or per-layer uniforms JAX's), a weighted step (the aux term
  left out, as the JAX weighted loss leaves it out) and an outer step:
  losses and every weight atol 1e-5, the hypergradient within 1e-5 of
  each meta parameter's largest element, the meta parameters atol 1e-6
  (``tests/test_torch_meta_trainer.py``'s tolerances).
* NCL and ICLRec: the port refuses them by name, because the JAX package
  fails there: its bilevel epoch never calls ``refresh_state``, so the
  first warm step reads prototypes or intents that were never fitted
  (``KeyError``). The JAX failure is asserted too, so that a JAX package
  that changes says so here.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from torch_dist_parity import jax_draws
from torch_meta_parity import (
    CONFIG_DIR,
    assert_close_to_largest,
    jax_meta_as_port,
    outer_draws,
    weighted_draws,
)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
from torch_zoo_parity import assert_grads_match

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.synthetic import synthetic_config
from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu.ops.attention import reference_attention
from dr4sr_tpu.meta.hypergrad import hypergradient as jax_hypergradient
from dr4sr_tpu.train.meta_trainer import MetaTrainer as JaxMetaTrainer
from dr4sr_tpu_torch.convert import meta_params_from_jax, params_from_jax
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.train.meta_trainer import MetaTrainer

NUM_ITEMS, L, BATCH = 40, 10, 16
ATOL = 1e-5
HYPER_RTOL = 1e-5
META_ATOL = 1e-6
SMALL = {"embed_dim": 16, "hidden_size": 32, "head_num": 2, "layer_num": 1,
         "dropout_rate": 0.0, "ssl_ratio": 0.2, "ssl_weight": 0.3, "num_clusters": 4,
         "num_intent_clusters": 4}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("meta_aux"))
    jax_write(path, num_users=60, num_items=NUM_ITEMS, max_seq_len=L, seed=3)
    return path


def _config(sub_model):
    cfg = synthetic_config(max_seq_len=L)
    cfg["model"].update(model="MetaModel", sub_model=sub_model, tau_min=1.0)
    cfg["train"].update(batch_size=BATCH, warmup_epoch=0, interval=3, meta_optimizer="sgd",
                        meta_learning_rate=1e-2, hpo_learning_rate=1e-3,
                        meta_weight_decay=1e-3)
    cfg["_cli_overrides"] = {"model": dict(SMALL), "train": {"batch_size": BATCH}}
    return cfg


def _t(x):
    return torch.tensor(np.asarray(x))


class _Pair:
    """The JAX trainer and the port's (CPU) from JAX's weights, and the
    padded last batch of epoch 1 on both sides."""

    def __init__(self, sub_model, root):
        cfg = _config(sub_model)
        self.jax = JaxMetaTrainer(copy.deepcopy(cfg), jax_prepare_datasets(cfg, root=root),
                                  config_dir=CONFIG_DIR)
        self.jax.init_state(seed=0)
        self.port = MetaTrainer(copy.deepcopy(cfg), prepare_datasets(cfg, root=root),
                                device="cpu", config_dir=CONFIG_DIR)
        self.port.init_state(seed=0)
        module = self.port.rec.module
        params = jax.tree_util.tree_map(np.asarray, self.jax.state.params)
        module.load_state_dict(params_from_jax(params, module))
        self.port.load_meta(*meta_params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jax.meta_params), self.port.meta_module))
        self.batch = list(self.port.train_data.get_loader(seed=1))[-1]
        assert not self.batch["valid"].all()
        self.jbatch = self.jax._device_batch(self.batch, is_train=True)
        self.dbatch = self.port.device_batch(self.batch, is_train=True)


@pytest.mark.parametrize("sub_model", ["SGL", "SimGCL"])
def test_warm_step_adds_the_aux_term(root, sub_model):
    """The warm step is the plain step: main loss plus the aux term."""
    p = _Pair(sub_model, root)
    key = jax.random.PRNGKey(11)
    want, want_grads = jax.value_and_grad(p.jax._loss_fn)(p.jax.state.params, p.jbatch, key)
    neg, _, aux = jax_draws(p.jax, p.jbatch, key)
    assert aux is not None
    got = p.port.train_step(p.dbatch, neg_id=_t(neg).long(), aux_draws=aux)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    assert_grads_match(p.port.rec.module, jax.tree_util.tree_map(np.asarray, want_grads), ATOL)


@pytest.mark.parametrize("sub_model", ["SGL", "SimGCL"])
def test_weighted_step_leaves_the_aux_term_out(root, sub_model):
    p = _Pair(sub_model, root)
    key = jax.random.PRNGKey(5)
    want, want_grads = jax.value_and_grad(
        lambda q: p.jax._weighted_loss(q, p.jax.meta_params, p.jbatch, key))(p.jax.state.params)
    neg, _, noise = weighted_draws(p.jax, p.jbatch, key)
    got = p.port.weighted_train_step(p.dbatch, neg_id=neg, noise=noise)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    assert_grads_match(p.port.rec.module, jax.tree_util.tree_map(np.asarray, want_grads), ATOL)


@pytest.mark.parametrize("sub_model", ["SGL", "SimGCL"])
def test_outer_step_matches_jax(root, sub_model):
    p = _Pair(sub_model, root)
    loader = p.port.train_data.get_loader(seed=4099)
    vb, tb = loader.sample_batch(), loader.sample_batch()
    jval, jtrain = (p.jax._device_batch(b, is_train=True) for b in (vb, tb))
    key = jax.random.PRNGKey(9)
    r_val, r_train = jax.random.split(key)
    with reference_attention():
        want_h = jax_hypergradient(
            lambda q, m: p.jax._weighted_loss(q, m, jtrain, r_train),
            lambda q: p.jax.rec.training_loss({"params": q}, jval, r_val),
            p.jax.state.params, p.jax.meta_params, lr=p.jax.hpo_lr, truncate_iter=3)
    want_meta, _ = p.jax.outer_step(p.jax.state.params, p.jax.meta_params,
                                    p.jax.meta_opt_state, jval, jtrain, key)
    val_neg, train_neg, noise = outer_draws(p.jax, jval, jtrain, key)
    got_h = p.port.outer_step(p.port.device_batch(vb, is_train=True),
                              p.port.device_batch(tb, is_train=True), val_neg=val_neg,
                              train_neg=train_neg, noise=noise)
    assert_close_to_largest(got_h, jax_meta_as_port(want_h, p.port.meta_module), HYPER_RTOL,
                            "hypergradient")
    for k, w in jax_meta_as_port(want_meta, p.port.meta_module).items():
        np.testing.assert_allclose(p.port.meta_params[k].detach().numpy(), w.numpy(),
                                   atol=META_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("sub_model,state", [("NCL", "proto_centroids"),
                                             ("ICLRec", "intent_centroids")])
def test_the_port_refuses_what_the_jax_package_fails_on(root, sub_model, state):
    cfg = _config(sub_model)
    with pytest.raises(NotImplementedError, match="refresh_state"):
        MetaTrainer(copy.deepcopy(cfg), prepare_datasets(cfg, root=root), device="cpu",
                    config_dir=CONFIG_DIR)
    jax_tr = JaxMetaTrainer(copy.deepcopy(cfg), jax_prepare_datasets(cfg, root=root),
                            config_dir=CONFIG_DIR)
    jax_tr.init_state(seed=0)
    with pytest.raises(KeyError, match=state):
        jax_tr.training_epoch(0)
