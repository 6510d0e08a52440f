"""GNN in the port against the JAX package:

* ``build_transition_graph`` equal to JAX's element for element ('old' and
  'new' rows, windows 1–3, the no-edge case), and the trainers' edges;
* the first step's loss and every gradient of the trainer's loss from the
  same weights and JAX's negatives (dropout 0), atol 1e-5;
* eval top-k from weights carried by ``convert.params_from_jax``, scores
  atol 1e-5;
* serving refuses GNN (its encoder reads the graph, which neither package's
  ``Recommender`` builds) and serves SGL, whose graph feeds only its loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
from torch_zoo_parity import assert_grads_match, assert_topk_match, to_jax, zoo_config

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu.models.base import sample_negatives as jax_sample_negatives
from dr4sr_tpu.models.gnn import build_transition_graph as jax_build_graph
from dr4sr_tpu.train.trainer import Trainer as JaxTrainer
from dr4sr_tpu_torch.convert import params_from_jax
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.gnn import build_transition_graph
from dr4sr_tpu_torch.serve import Recommender
from dr4sr_tpu_torch.train.trainer import Trainer

NUM_ITEMS, L = 40, 10
ATOL = 1e-5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gnn"))
    jax_write(path, num_users=60, num_items=NUM_ITEMS, max_seq_len=L, seed=3)
    return path


def _config(model="GNN", **model_cfg):
    cfg = zoo_config(model, L, **{"gnn_layer": 3, "graph": "old", "window": 2, **model_cfg})
    cfg["train"]["batch_size"] = 16
    return cfg


@pytest.mark.parametrize("window", [1, 2, 3])
@pytest.mark.parametrize("graph", ["old", "new"])
def test_transition_graph_equals_jax(root, graph, window):
    train, val, _ = jax_prepare_datasets(_config(), root=root)
    rows = (val if graph == "old" else train).rows()
    drop_last = graph == "old"
    want = jax_build_graph(rows.in_item_id, rows.seqlen, NUM_ITEMS, window, drop_last)
    got = build_transition_graph(rows.in_item_id, rows.seqlen, NUM_ITEMS, window, drop_last)
    assert len(got[0]) > NUM_ITEMS  # edges beyond the self-loops
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_transition_graph_without_edges_equals_jax():
    """Rows of one item have no transitions: the identity, as in JAX."""
    seqs = np.zeros((5, L), np.int32)
    seqs[:, 0] = np.arange(1, 6)
    lens = np.ones(5, np.int32)
    for drop_last in (False, True):
        want = jax_build_graph(seqs, lens, NUM_ITEMS, 2, drop_last)
        got = build_transition_graph(seqs, lens, NUM_ITEMS, 2, drop_last)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _jax_trainer(config, root):
    trainer = JaxTrainer(config, jax_prepare_datasets(config, root=root))
    trainer.init_state(seed=0)
    return trainer, jax.tree_util.tree_map(np.asarray, trainer.state.params)


def _port_trainer(config, root, params):
    trainer = Trainer(config, prepare_datasets(config, root=root), device="cpu")
    trainer.init_state()
    module = trainer.rec.module
    module.load_state_dict(params_from_jax(params, module))
    return trainer


@pytest.mark.parametrize("graph", ["old", "new"])
def test_trainer_edges_equal_jax(root, graph):
    config = _config(graph=graph)
    jax_trainer = JaxTrainer(config, jax_prepare_datasets(config, root=root))
    trainer = Trainer(config, prepare_datasets(config, root=root), device="cpu")
    assert sorted(trainer.batch_extras) == sorted(jax_trainer.batch_extras)
    for key, want in jax_trainer.batch_extras.items():
        np.testing.assert_array_equal(trainer.batch_extras[key].numpy(), np.asarray(want))


def test_first_step_loss_and_gradients_match_jax(root):
    """No aux or contrastive term: the JAX ``_loss_fn`` hands its key to
    ``training_loss``, which splits negatives from dropout."""
    config = _config()
    jax_trainer, params = _jax_trainer(config, root)
    batch = list(jax_prepare_datasets(config, root=root)[0].get_loader(seed=1))[-1]
    jbatch = dict(to_jax(batch), **jax_trainer.batch_extras)
    key = jax.random.PRNGKey(7)
    want, want_grads = jax.value_and_grad(jax_trainer._loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params), jbatch, key)
    neg = jax_sample_negatives(jax.random.split(key)[0], jbatch, NUM_ITEMS, L)

    trainer = _port_trainer(config, root, params)
    got = trainer.loss(trainer.device_batch(batch, is_train=True),
                       neg_id=torch.tensor(np.asarray(neg)).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    module = trainer.rec.module
    assert not hasattr(module.backbone, "item_embedding")  # as the JAX tree
    assert_grads_match(module, jax.tree_util.tree_map(np.asarray, want_grads), ATOL)


def test_eval_topk_matches_jax(root):
    config = _config()
    jax_trainer, params = _jax_trainer(config, root)
    # a few Adam steps first, so the propagated table is not the initial one
    batches = list(jax_prepare_datasets(config, root=root)[0].get_loader(seed=0))[:3]
    state = jax_trainer.state
    for i, b in enumerate(batches):
        state, _ = jax_trainer.train_step(state, jax_trainer._device_batch(b, is_train=True),
                                          jax.random.PRNGKey(i))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    val = next(iter(jax_prepare_datasets(config, root=root)[1].get_loader()))
    jbatch = dict(to_jax(val), **jax_trainer.batch_extras)
    want_s, want_i = jax_trainer.rec.topk({"params": params}, jbatch, 10)

    trainer = _port_trainer(config, root, params)
    got_s, got_i = trainer.rec.topk(trainer.device_batch(val), 10)
    assert_topk_match(got_i.numpy(), got_s.detach().numpy(), want_i, want_s, ATOL)


def test_serving_refuses_gnn_and_serves_sgl(root):
    for model, refused in (("GNN", True), ("SGL", False)):
        config = _config(model)
        trainer = Trainer(config, prepare_datasets(config, root=root), device="cpu")
        trainer.init_state()
        rec = RecModel(config, trainer.rec.module, NUM_ITEMS, 1)
        if refused:
            with pytest.raises(NotImplementedError, match="item-transition graph"):
                Recommender(rec, rec.module.state_dict(), device="cpu")
        else:
            items, scores = Recommender(rec, rec.module.state_dict(), device="cpu").recommend(
                [[1, 2, 3], [4]], k=5)
            assert items.shape == (2, 5) and np.isfinite(scores).all()
