"""SGL, SimGCL and NCL in the port against the JAX package, from the same
weights (dropout 0) and JAX's draws, reproduced from its keys: the JAX
``Trainer._loss_fn`` splits the aux term's key off first, then
``training_loss`` splits negatives from dropout; SGL and SimGCL split the
aux key in two, one a view (an edge mask; per-layer uniforms split off
the view's key layer by layer).

* each model's aux term and its gradients, atol 1e-5;
* the trainer's whole first-step loss and every gradient, atol 1e-5;
* NCL's ``refresh_state`` prototypes from JAX's initial rows: centroids
  atol 1e-5, assignments equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
from torch_zoo_parity import assert_grads_match, to_jax, zoo_config

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu.models.base import sample_negatives as jax_sample_negatives
from dr4sr_tpu.models.registry import get_model_class as jax_model_class
from dr4sr_tpu.train.trainer import Trainer as JaxTrainer
from dr4sr_tpu_torch.convert import params_from_jax
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.modules.graph_augmentation import fit_prototypes, kmeans_init
from dr4sr_tpu_torch.train.trainer import Trainer

NUM_ITEMS, L, EMBED = 40, 10, 16
ATOL = 1e-5
MODELS = ("SGL", "SimGCL", "NCL")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("graph_cl"))
    jax_write(path, num_users=60, num_items=NUM_ITEMS, max_seq_len=L, seed=5)
    return path


def _config(model):
    cfg = zoo_config(model, L, graph="new", window=2, gnn_layer=2, ssl_ratio=0.2,
                     noise_eps=0.1, ssl_weight=0.3, proto_weight=0.2, ssl_temperature=0.2,
                     hyper_layers=1, num_clusters=4)
    cfg["train"]["batch_size"] = 16
    return cfg


def _jax_noise(key):
    """SimGCL's per-layer uniforms, split as ``propagate_mean`` splits them."""
    out = []
    for _ in range(2):
        key, r = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(r, (NUM_ITEMS, EMBED))))
    return torch.from_numpy(np.stack(out))


def jax_aux_draws(model, r_aux, num_edges):
    """The port's ``aux_draws`` for JAX's aux key."""
    if model == "NCL":
        return None
    r1, r2 = jax.random.split(r_aux)
    if model == "SGL":
        return [torch.from_numpy(np.array(jax.random.bernoulli(r, 0.8, (num_edges,))))
                for r in (r1, r2)]
    return [_jax_noise(r) for r in (r1, r2)]


class _Setup:
    """The JAX trainer and its weights, the port's trainer with the same
    weights, a padded last batch (JAX batch with the extras), and for NCL the
    JAX prototypes of epoch 0 in both trainers' extras."""

    def __init__(self, model, root):
        config = _config(model)
        self.model, self.config = model, config
        self.jax = JaxTrainer(config, jax_prepare_datasets(config, root=root))
        self.jax.init_state(seed=0)
        self.params = jax.tree_util.tree_map(np.asarray, self.jax.state.params)
        self.port = Trainer(config, prepare_datasets(config, root=root), device="cpu")
        self.port.init_state()
        module = self.port.rec.module
        module.load_state_dict(params_from_jax(self.params, module))
        if model == "NCL":
            self.jax.batch_extras.update(jax_model_class("NCL").refresh_state(self.jax, 0))
            self.port.batch_extras.update(
                {k: torch.from_numpy(np.array(v)).to(torch.long if v.dtype.kind == "i"
                                                       else torch.float32)
                 for k, v in self.jax.batch_extras.items() if k.startswith("proto_")})
        self.batch = list(jax_prepare_datasets(config, root=root)[0].get_loader(seed=1))[-1]
        assert not self.batch["valid"].all()
        self.jbatch = dict(to_jax(self.batch), **self.jax.batch_extras)


@pytest.mark.parametrize("model", MODELS)
def test_aux_term_matches_jax(root, model):
    s = _Setup(model, root)
    r_aux = jax.random.PRNGKey(21)
    cls = jax_model_class(model)
    want, want_grads = jax.value_and_grad(lambda p: cls.aux_loss(
        s.jax.rec.module, {"params": p}, s.jbatch, r_aux, s.config["model"], NUM_ITEMS))(
        jax.tree_util.tree_map(jnp.asarray, s.params))
    batch = s.port.device_batch(s.batch, is_train=True)
    draws = jax_aux_draws(model, r_aux, batch["edge_row"].shape[0])
    module = s.port.rec.module
    got = s.port.model_class.aux_loss(module, batch, s.config["model"], NUM_ITEMS, draws)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    grad = module.item_embedding.weight.grad.numpy()
    want_grad = np.asarray(want_grads["item_embedding"]["embedding"])
    np.testing.assert_allclose(grad, want_grad, atol=ATOL * np.abs(want_grad).max())
    assert np.abs(want_grad).max() > 0


@pytest.mark.parametrize("model", MODELS)
def test_trainer_loss_and_gradients_match_jax(root, model):
    s = _Setup(model, root)
    key = jax.random.PRNGKey(11)
    want, want_grads = jax.value_and_grad(s.jax._loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, s.params), s.jbatch, key)
    rest, r_aux = jax.random.split(key)
    neg = jax_sample_negatives(jax.random.split(rest)[0], s.jbatch, NUM_ITEMS, L)
    batch = s.port.device_batch(s.batch, is_train=True)
    got = s.port.loss(batch, neg_id=torch.tensor(np.asarray(neg)).long(),
                      aux_draws=jax_aux_draws(model, r_aux, batch["edge_row"].shape[0]))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    assert_grads_match(s.port.rec.module, jax.tree_util.tree_map(np.asarray, want_grads), ATOL)


@pytest.mark.parametrize("nepoch", [0, 3])
def test_ncl_prototypes_match_jax(root, nepoch):
    s = _Setup("NCL", root)
    want = jax_model_class("NCL").refresh_state(s.jax, nepoch)
    table = s.port.rec.module.item_embedding.weight.detach()
    init = jax.random.choice(jax.random.PRNGKey(nepoch), NUM_ITEMS - 1, shape=(4,),
                             replace=False)
    got = fit_prototypes(table, 4, torch.from_numpy(np.array(init)).long())
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want["proto_centroids"]),
                               atol=ATOL)
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want["proto_assign"]))
    # the port's own hook: the same fit from its own initial rows of the epoch
    s.port.refresh_state(nepoch)
    own = fit_prototypes(table, 4, kmeans_init(NUM_ITEMS - 1, 4, nepoch))
    assert torch.equal(s.port.batch_extras["proto_centroids"], own.centroids)
    assert torch.equal(s.port.batch_extras["proto_assign"], own.assign)
    assert own.assign.shape == (NUM_ITEMS,)
