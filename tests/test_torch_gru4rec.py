"""GRU4Rec in the port against the JAX package, weights carried over by
``convert.params_from_jax``:

* the conversion maps every JAX leaf (``GRUStack`` cells onto ``nn.GRU``'s
  ``weight_ih_lk``/``weight_hh_lk``) and back, and refuses a tree with a
  leaf too many or too few;
* the encoder in train mode ('origin' pooling, dropout 0) and eval mode
  ('last') against the JAX ``GRU4RecEncoder``, atol 1e-5;
* the first step's BCE loss and every gradient from the same negatives,
  atol 1e-5;
* the weights are U(−1/√H, 1/√H) from the explicit generator;
* ``Recommender.from_checkpoint`` of a JAX GRU4Rec checkpoint serves what
  the JAX ``Recommender`` serves (scores atol 1e-5).
"""

import jax
import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
from torch_zoo_parity import (
    assert_grads_match,
    assert_topk_match,
    jax_loss_and_grads,
    jax_rec_and_params,
    port_rec,
    to_jax,
    to_torch,
    zoo_config,
)

from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu.serve import Recommender as JaxRecommender
from dr4sr_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dr4sr_tpu_torch.convert import params_from_jax
from dr4sr_tpu_torch.models.gru4rec import GRU4Rec
from dr4sr_tpu_torch.serve import Recommender

NUM_ITEMS, L, B = 40, 10, 6
ATOL = 1e-5


def _batch(seed):
    """A train batch whose last two rows are padding (valid=False)."""
    rng = np.random.default_rng(seed)
    seqlen = np.array([L, 5, 1, 7, 2, 1])
    seq = rng.integers(1, NUM_ITEMS, size=(B, L))
    target = rng.integers(1, NUM_ITEMS, size=(B, L))
    pad = np.arange(L)[None, :] >= seqlen[:, None]
    seq[pad] = 0
    target[pad] = 0
    batch = {"in_item_id": seq, "item_id": target, "seqlen": seqlen,
             "valid": np.arange(B) < 4}
    return batch, rng.integers(1, NUM_ITEMS, size=(B, L, 1))


@pytest.fixture(scope="module")
def jax_side():
    config = zoo_config("GRU4Rec", L)
    rec, params = jax_rec_and_params(config, NUM_ITEMS, _batch(0)[0])
    return config, rec, params


def test_params_from_jax_round_trip(jax_side):
    config, _, params = jax_side
    assert sorted(params["gru"]) == ["cell_0", "cell_0_wi", "cell_1", "cell_1_wi"]
    module = GRU4Rec.build(config, NUM_ITEMS)
    state = params_from_jax(params, module)
    assert sorted(state) == sorted(module.state_dict())
    for k in range(2):
        np.testing.assert_array_equal(state[f"gru.weight_ih_l{k}"].numpy(),
                                      params["gru"][f"cell_{k}_wi"]["kernel"].T)
        np.testing.assert_array_equal(state[f"gru.weight_hh_l{k}"].numpy(),
                                      params["gru"][f"cell_{k}"]["wh"]["kernel"].T)
    np.testing.assert_array_equal(state["out_proj.bias"].numpy(), params["out_proj"]["bias"])
    extra = {**params, "bogus": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="no counterpart"):
        params_from_jax(extra, module)
    short = {k: v for k, v in params.items() if k != "out_proj"}
    with pytest.raises(ValueError, match="no JAX param"):
        params_from_jax(short, module)


@pytest.mark.parametrize("training", [True, False])
def test_encoder_matches_jax(jax_side, training):
    config, rec, params = jax_side
    batch, _ = _batch(1)
    want = np.asarray(rec.module.apply({"params": params}, to_jax(batch), training=training,
                                       rngs={"dropout": jax.random.PRNGKey(0)}))
    module = port_rec(config, NUM_ITEMS, params).module.train(training)
    with torch.no_grad():
        got = module(to_torch(batch)).numpy()
    assert got.shape == ((B, L, 16) if training else (B, 16))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_first_step_matches_jax(jax_side):
    config, rec, params = jax_side
    batch, neg = _batch(2)
    want_loss, want_grads = jax_loss_and_grads(rec, params, batch, neg)
    port = port_rec(config, NUM_ITEMS, params)
    loss = port.training_loss(to_torch(batch), None, neg_id=torch.from_numpy(neg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL)
    assert_grads_match(port.module, want_grads, ATOL)


def test_gru_weights_are_uniform_from_the_generator():
    config = zoo_config("GRU4Rec", L, hidden_size=64)
    a = GRU4Rec.build(config, NUM_ITEMS, generator=torch.Generator().manual_seed(3))
    b = GRU4Rec.build(config, NUM_ITEMS, generator=torch.Generator().manual_seed(3))
    bound = 1 / np.sqrt(64)
    for name, w in a.gru.named_parameters():
        assert torch.equal(w, b.gru.get_parameter(name)), name  # the generator's draws
        assert w.abs().max() <= bound and w.std() > 0.4 * bound, name
    assert not any("bias" in name for name, _ in a.gru.named_parameters())


def test_recommender_from_a_jax_checkpoint(jax_side, tmp_path):
    config, rec, params = jax_side
    root = str(tmp_path / "data")
    jax_write(root, num_users=20, num_items=NUM_ITEMS, max_seq_len=L, seed=0)
    path = str(tmp_path / "gru4rec.ckpt")
    jax_save_checkpoint(path, params, config, "GRU4Rec", 1, {"ndcg@20": 0.1})
    histories = [[1, 2, 3], [5], list(range(1, 15)), []]
    want_i, want_s = JaxRecommender(rec, params, batch_size=3).recommend(histories, k=5)
    got_i, got_s = Recommender.from_checkpoint(path, root=root, batch_size=3,
                                               device="cpu").recommend(histories, k=5)
    assert_topk_match(got_i, got_s, want_i, want_s, ATOL)
