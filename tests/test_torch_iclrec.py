"""ICLRec in the port against the JAX package, from the same weights
(dropout 0) and JAX's draws, reproduced from its keys (the JAX
``_loss_fn`` splits the aux key off first; ``aux_loss`` splits it into the
views' key and the pooled encode's dropout key; the views' key splits four
ways, the first two the views' augmentations):

* the refresh's pooled representations of every train row (eval mode,
  unshuffled, padded rows left out) and its k-means centroids from JAX's
  initial rows, atol 1e-5;
* the instance term, the intent term and the aux term as the model weighs
  them, with their gradients, atol 1e-5 (1e-5 of the largest gradient);
* the trainer's whole first-step loss and every gradient;
* the pooled encode, which only picks each row's intent, runs without
  gradient; the two views' encodes take it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
from torch_zoo_parity import assert_grads_match, jax_aug_draws, to_jax, zoo_config

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu.models.base import sample_negatives as jax_sample_negatives
from dr4sr_tpu.models.iclrec import ICLRec as JaxICLRec
from dr4sr_tpu.modules.layers import seq_pooling as jax_seq_pooling
from dr4sr_tpu.train.trainer import Trainer as JaxTrainer
from dr4sr_tpu_torch.convert import params_from_jax
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.models.iclrec import ICLRec
from dr4sr_tpu_torch.modules.graph_augmentation import kmeans
from dr4sr_tpu_torch.train.trainer import Trainer

NUM_ITEMS, L, K = 40, 10, 4
ATOL = 1e-5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iclrec"))
    jax_write(path, num_users=70, num_items=NUM_ITEMS, max_seq_len=L, seed=6)
    return path


def _config(kind="item_random", w_instance=0.1, w_intent=0.1):
    cfg = zoo_config("ICLRec", L, augment_type=kind, temperature=0.7,
                     instance_weight=w_instance, intent_weight=w_intent,
                     num_intent_clusters=K)
    cfg["train"]["batch_size"] = 16
    return cfg


@pytest.fixture(scope="module")
def trained(root):
    """JAX weights after a few Adam steps (so the reps are not the initial
    ones), and the JAX refresh of epoch 2 under them."""
    config = _config()
    trainer = JaxTrainer(config, jax_prepare_datasets(config, root=root))
    trainer.init_state(seed=0)
    trainer.batch_extras.update(JaxICLRec.refresh_state(trainer, 0))
    state = trainer.state
    for i, b in zip(range(4), trainer.train_data.get_loader(seed=0)):
        state, _ = trainer.train_step(state, trainer._device_batch(b, is_train=True),
                                      jax.random.PRNGKey(i))
    trainer.state = state
    refreshed = JaxICLRec.refresh_state(trainer, 2)
    return jax.tree_util.tree_map(np.asarray, state.params), refreshed


def _port(config, root, params, extras=None):
    trainer = Trainer(config, prepare_datasets(config, root=root), device="cpu")
    trainer.init_state()
    module = trainer.rec.module
    module.load_state_dict(params_from_jax(params, module))
    if extras is not None:
        trainer.batch_extras.update(
            {k: torch.from_numpy(np.array(v)) for k, v in extras.items()})
    return trainer


def _jax_pooled_reps(config, root, params):
    trainer = JaxTrainer(config, jax_prepare_datasets(config, root=root))
    reps = []
    for b in trainer.train_data.get_loader(shuffle=False):
        out = trainer.rec.module.apply({"params": params}, to_jax(b), training=False,
                                       need_pooling=False)
        reps.append(np.asarray(jax_seq_pooling(out, jnp.asarray(b["seqlen"]), "mean"))[b["valid"]])
    return np.concatenate(reps)


def test_refresh_reps_and_centroids_match_jax(root, trained):
    params, refreshed = trained
    config = _config()
    trainer = _port(config, root, params)
    reps = ICLRec.pooled_train_reps(trainer)
    want_reps = _jax_pooled_reps(config, root, params)
    assert reps.shape == want_reps.shape == (len(trainer.train_data), 16)
    np.testing.assert_allclose(reps.numpy(), want_reps, atol=ATOL)
    assert trainer.rec.module.training  # the refresh leaves the train mode as it was
    init = jax.random.choice(jax.random.PRNGKey(2), reps.shape[0], shape=(K,), replace=False)
    cents, _ = kmeans(reps, K, torch.from_numpy(np.array(init)).long())
    np.testing.assert_allclose(cents.numpy(), np.asarray(refreshed["intent_centroids"]),
                               atol=ATOL)
    trainer.refresh_state(2)  # the port's own hook: K centroids of the same reps
    assert trainer.batch_extras["intent_centroids"].shape == (K, 16)


def _jax_loss_setup(config, root, params, refreshed):
    trainer = JaxTrainer(config, jax_prepare_datasets(config, root=root))
    batch = list(jax_prepare_datasets(config, root=root)[0].get_loader(seed=1))[-1]
    assert not batch["valid"].all()
    return trainer, batch, dict(to_jax(batch), **refreshed)


def _views(kind, r_aux, seqlen):
    r_main, _ = jax.random.split(r_aux)
    r_i, r_j, _, _ = jax.random.split(r_main, 4)
    return [jax_aug_draws(kind, r, seqlen, L) for r in (r_i, r_j)]


@pytest.mark.parametrize("weights", [(1.0, 0.0), (0.0, 1.0), (0.1, 0.1)],
                         ids=["instance", "intent", "both"])
@pytest.mark.parametrize("kind", ["item_mask", "item_random"])
def test_aux_terms_match_jax(root, trained, kind, weights):
    params, refreshed = trained
    config = _config(kind, *weights)
    jax_trainer, batch, jbatch = _jax_loss_setup(config, root, params, refreshed)
    r_aux = jax.random.PRNGKey(31)
    want, want_grads = jax.value_and_grad(lambda p: JaxICLRec.aux_loss(
        jax_trainer.rec.module, {"params": p}, jbatch, r_aux, config["model"], NUM_ITEMS))(
        jax.tree_util.tree_map(jnp.asarray, params))
    trainer = _port(config, root, params, refreshed)
    module = trainer.rec.module
    module.train()
    got = ICLRec.aux_loss(module, trainer.device_batch(batch, is_train=True), config["model"],
                          NUM_ITEMS, _views(kind, r_aux, batch["seqlen"]))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    grads = jax.tree_util.tree_map(np.asarray, want_grads)
    largest = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(grads))
    assert largest > 0
    assert_grads_match(module, grads, ATOL * largest)


def test_trainer_loss_and_gradients_match_jax(root, trained):
    params, refreshed = trained
    config = _config()
    jax_trainer, batch, jbatch = _jax_loss_setup(config, root, params, refreshed)
    key = jax.random.PRNGKey(12)
    want, want_grads = jax.value_and_grad(jax_trainer._loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params), jbatch, key)
    rest, r_aux = jax.random.split(key)
    neg = jax_sample_negatives(jax.random.split(rest)[0], jbatch, NUM_ITEMS, L)
    trainer = _port(config, root, params, refreshed)
    got = trainer.loss(trainer.device_batch(batch, is_train=True),
                       neg_id=torch.tensor(np.asarray(neg)).long(),
                       aux_draws=_views("item_random", r_aux, batch["seqlen"]))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    assert_grads_match(trainer.rec.module, jax.tree_util.tree_map(np.asarray, want_grads), ATOL)
    assert trainer.rec.module.item_embedding.weight.shape[0] == NUM_ITEMS + 1  # the mask token


def test_pooled_encode_takes_no_gradient(root, trained):
    params, refreshed = trained
    config = _config()
    trainer = _port(config, root, params, refreshed)
    module = trainer.rec.module
    module.train()
    grad_enabled = []
    hook = module.encoder.register_forward_hook(
        lambda *_: grad_enabled.append(torch.is_grad_enabled()))
    batch = trainer.device_batch(next(iter(trainer.train_batches(0))), is_train=True)
    draws = ICLRec.aux_draws(torch.Generator().manual_seed(0), batch, config["model"], NUM_ITEMS)
    ICLRec.aux_loss(module, batch, config["model"], NUM_ITEMS, draws).backward()
    hook.remove()
    assert grad_enabled == [False, True, True]  # pooled, then the two views
