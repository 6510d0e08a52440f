"""The port's train step against the JAX package on the same weights:

* SASRec's training loss and the gradient of every parameter against
  ``jax.grad`` of the JAX loss — dropout 0, the same negatives fed to both,
  and a padded batch with ``valid=False`` rows. Tolerance: atol 2e-5 on the
  loss and 2e-5 on the gradients (flax's LayerNorm takes the variance in one
  pass, PyTorch in two; the sums run in another order);
* ``make_optimizer`` against the JAX package's optax chain, 5 steps on the
  same gradients at the configs' learning rate 1e-3, at atol 1e-6 (optax
  takes Adam's bias corrections in f32, PyTorch in f64: about 1e-5
  relative on the first steps' updates);
* ``RecModel.encode_eval`` restores the module's previous mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.data.synthetic import synthetic_config
from dr4sr_tpu.models.base import LOSS_FNS as JAX_LOSS_FNS
from dr4sr_tpu.models.base import RecModel as JaxRecModel
from dr4sr_tpu.models.base import item_table as jax_item_table
from dr4sr_tpu.models.base import pos_neg_scores as jax_pos_neg_scores
from dr4sr_tpu.models.sasrec import SASRec as JaxSASRec
from dr4sr_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dr4sr_tpu_torch.convert import sasrec_params_from_jax
from dr4sr_tpu_torch.models.base import RecModel, sample_negatives
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.train.trainer import make_optimizer

NUM_ITEMS = 40
L = 12
B = 6


def _config(loss_fn="bce"):
    config = synthetic_config(max_seq_len=L)
    config["model"].update(embed_dim=16, hidden_size=32, head_num=2, layer_num=2,
                           dropout_rate=0.0, loss_fn=loss_fn)
    return config


def _batch(seed):
    """A train batch whose last two rows are padding (valid=False)."""
    rng = np.random.default_rng(seed)
    seqlen = np.array([L, 5, 1, 9, 1, 1])
    seq = rng.integers(1, NUM_ITEMS, size=(B, L))
    target = rng.integers(1, NUM_ITEMS, size=(B, L))
    pad = np.arange(L)[None, :] >= seqlen[:, None]
    seq[pad] = 0
    target[pad] = 0
    valid = np.arange(B) < 4
    neg = rng.integers(1, NUM_ITEMS, size=(B, L, 1))
    return {"in_item_id": seq, "item_id": target, "seqlen": seqlen, "valid": valid}, neg


@pytest.fixture(scope="module")
def jax_params():
    config = _config()
    jax_rec = JaxRecModel(config, JaxSASRec.build(config, NUM_ITEMS), NUM_ITEMS, 1)
    batch, _ = _batch(0)
    variables = jax_rec.init(jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, batch))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.mark.parametrize("loss_fn", ["bce", "bpr"])
def test_training_loss_and_gradients_match_jax(jax_params, loss_fn):
    config = _config(loss_fn)
    jax_rec = JaxRecModel(config, JaxSASRec.build(config, NUM_ITEMS), NUM_ITEMS, 1)
    batch, neg = _batch(1)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def jax_loss(params):
        variables = {"params": params}
        query = jax_rec.module.apply(variables, jbatch, training=True,
                                     rngs={"dropout": jax.random.PRNGKey(1)})
        pos, negs, mask = jax_pos_neg_scores(query, jax_item_table(variables), jbatch,
                                             jnp.asarray(neg))
        return JAX_LOSS_FNS[loss_fn](pos, negs, mask)

    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)

    module = SASRec.build(config, NUM_ITEMS)
    module.load_state_dict(sasrec_params_from_jax(jax_params, module))
    rec = RecModel(config, module, NUM_ITEMS, 1)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = rec.training_loss(tbatch, None, neg_id=torch.from_numpy(neg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=2e-5)
    want = sasrec_params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads), module)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)


def test_alignment_uniformity_loss_matches_jax(jax_params):
    config = _config()
    jax_rec = JaxRecModel(config, JaxSASRec.build(config, NUM_ITEMS), NUM_ITEMS, 1)
    batch, _ = _batch(5)
    want = jax_rec.alignment_uniformity_loss(
        {"params": jax.tree_util.tree_map(jnp.asarray, jax_params)},
        jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0))
    module = SASRec.build(config, NUM_ITEMS)
    module.load_state_dict(sasrec_params_from_jax(jax_params, module))
    got = RecModel(config, module, NUM_ITEMS, 1).alignment_uniformity_loss(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), atol=2e-5)


def test_sampled_negatives_have_the_reference_shape_and_range():
    batch, _ = _batch(2)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    neg = sample_negatives(gen, tbatch, NUM_ITEMS, L)
    assert neg.shape == (B, L, 1)
    assert int(neg.min()) >= 1 and int(neg.max()) < NUM_ITEMS
    again = sample_negatives(torch.Generator().manual_seed(0), tbatch, NUM_ITEMS, L)
    assert torch.equal(neg, again)
    single = sample_negatives(gen, {"item_id": torch.zeros(B, dtype=torch.long)}, NUM_ITEMS, L)
    assert single.shape == (B, 1)


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop", "adagrad"])
def test_optimizer_matches_optax(name):
    cfg = {"optimizer": name, "learning_rate": 1e-3, "weight_decay": 0.01}
    rng = np.random.default_rng(3)
    p0 = {"w": rng.normal(size=(5, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]

    tx = jax_make_optimizer(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = make_optimizer(list(tp.values()), cfg)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6)


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer([torch.nn.Parameter(torch.zeros(1))], {"optimizer": "lamb"})


@pytest.mark.parametrize("training", [True, False])
def test_encode_eval_restores_the_mode(training):
    config = _config()
    config["model"]["dropout_rate"] = 0.5
    module = SASRec.build(config, NUM_ITEMS, generator=torch.Generator().manual_seed(0))
    rec = RecModel(config, module, NUM_ITEMS, 1)
    module.train(training)
    batch, _ = _batch(4)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        first = rec.encode_eval(tbatch)
        assert module.training is training
        second = rec.encode_eval(tbatch)
    assert first.shape == (B, 16)
    assert torch.equal(first, second)  # eval mode: no dropout
