"""FMLP in the port against the JAX package, weights carried over by
``convert.params_from_jax``:

* ``FilterLayer`` by ``torch.fft`` against the JAX layer's DFT-einsum path
  (its default) and its ``use_fft=True`` path, at the full length and a
  shorter one, odd and even, atol 1e-5;
* ``expand_prefix_rows`` and ``pre_pad_batch`` equal JAX's exactly;
* the encoder (train and eval mode, dropout 0) on pre-padded rows, and the
  first step's loss and gradients on prefix rows (1-D targets, [B, 1]
  negatives), atol 1e-5;
* serving pre-pads the histories: the port's ``Recommender`` answers what
  the JAX trainer's eval query gives (scores atol 1e-5), where the JAX
  ``Recommender`` right-pads and answers otherwise.
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

from dr4sr_tpu.data.dataset import RowData as JaxRowData
from dr4sr_tpu.models.fmlp import expand_prefix_rows as jax_expand_prefix_rows
from dr4sr_tpu.models.fmlp import pre_pad_batch as jax_pre_pad_batch
from dr4sr_tpu.modules.layers import FilterLayer as JaxFilterLayer
from dr4sr_tpu.serve import Recommender as JaxRecommender
from dr4sr_tpu_torch.convert import params_from_jax
from dr4sr_tpu_torch.data.dataset import RowData
from dr4sr_tpu_torch.models.base import sample_negatives
from dr4sr_tpu_torch.models.fmlp import expand_prefix_rows, pre_pad_batch
from dr4sr_tpu_torch.modules.layers import FilterLayer
from dr4sr_tpu_torch.serve import Recommender

NUM_ITEMS, L, D = 40, 12, 16
ATOL = 1e-5


def _rows(seed, n=7):
    """Right-padded train rows with per-position targets."""
    rng = np.random.default_rng(seed)
    seqlen = rng.integers(1, L + 1, size=n).astype(np.int32)
    seqlen[0] = L
    pad = np.arange(L)[None, :] >= seqlen[:, None]
    seq = np.where(pad, 0, rng.integers(1, NUM_ITEMS, size=(n, L))).astype(np.int32)
    target = np.where(pad, 0, rng.integers(1, NUM_ITEMS, size=(n, L))).astype(np.int32)
    return dict(user_id=np.arange(1, n + 1, dtype=np.int32), in_item_id=seq, item_id=target,
                seqlen=seqlen, label=(~pad).astype(np.float32),
                domain_id=np.zeros(n, np.int32))


@pytest.mark.parametrize("max_len, l", [(12, 12), (12, 7), (11, 11), (11, 8)])
def test_filter_layer_matches_both_jax_paths(max_len, l):
    x = np.random.default_rng(l).standard_normal((3, l, D)).astype(np.float32)
    layer = JaxFilterLayer(max_len, D, dropout=0.0)
    params = jax.tree_util.tree_map(np.asarray,
                                    layer.init(jax.random.PRNGKey(max_len), x)["params"])
    # a trained filter is no longer small: make the product count
    params["complex_weight"] = np.random.default_rng(1).standard_normal(
        params["complex_weight"].shape).astype(np.float32)
    ours = FilterLayer(max_len, D, dropout=0.0)
    ours.load_state_dict(params_from_jax(params, ours))
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    for use_fft in (False, True):
        want = JaxFilterLayer(max_len, D, dropout=0.0, use_fft=use_fft).apply(
            {"params": params}, x)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, err_msg=f"fft={use_fft}")


def test_expand_prefix_rows_and_pre_pad_equal_jax():
    fields = _rows(1)
    got = expand_prefix_rows(RowData(**fields))
    want = jax_expand_prefix_rows(JaxRowData(**fields))
    assert len(got) == int(fields["seqlen"].sum())
    for name in ("user_id", "in_item_id", "item_id", "seqlen", "label", "domain_id"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.item_id.ndim == 1 and got.user_hist is None
    batch = dict(fields, valid=np.ones(7, bool), user_hist=fields["in_item_id"].copy())
    a, b = pre_pad_batch(batch), jax_pre_pad_batch(batch)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_array_equal(a["user_hist"], fields["in_item_id"])  # untouched


@pytest.fixture(scope="module")
def jax_side():
    config = zoo_config("FMLP", L)
    sample = {"in_item_id": np.zeros((2, L), np.int32), "seqlen": np.ones(2, np.int32),
              "item_id": np.zeros(2, np.int32)}
    rec, params = jax_rec_and_params(config, NUM_ITEMS, sample)
    return config, rec, params


@pytest.mark.parametrize("training", [True, False])
def test_encoder_matches_jax(jax_side, training):
    config, rec, params = jax_side
    batch = jax_pre_pad_batch({k: v for k, v in _rows(2).items()
                               if k in ("in_item_id", "seqlen")})
    want = rec.module.apply({"params": params}, to_jax(batch), training=training,
                            rngs={"dropout": jax.random.PRNGKey(0)})
    module = port_rec(config, NUM_ITEMS, params).module.train(training)
    with torch.no_grad():
        got = module(to_torch(batch)).numpy()
    assert got.shape == (7, D)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_first_step_on_prefix_rows_matches_jax(jax_side):
    config, rec, params = jax_side
    rows = expand_prefix_rows(RowData(**_rows(3)))
    batch = {"in_item_id": rows.in_item_id[:16], "item_id": rows.item_id[:16],
             "seqlen": rows.seqlen[:16], "valid": np.arange(16) < 13}
    neg = sample_negatives(torch.Generator().manual_seed(0), to_torch(batch), NUM_ITEMS, L)
    assert neg.shape == (16, 1) and 1 <= int(neg.min()) and int(neg.max()) < NUM_ITEMS
    want_loss, want_grads = jax_loss_and_grads(rec, params, batch, neg.numpy())
    port = port_rec(config, NUM_ITEMS, params)
    loss = port.training_loss(to_torch(batch), None, neg_id=neg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL)
    assert_grads_match(port.module, want_grads, ATOL)


def test_serving_pre_pads_as_the_jax_trainer_evaluates(jax_side):
    config, rec, params = jax_side
    histories = [[3, 9, 1], [5], list(range(1, 16)), [7, 7, 2, 30, 11]]
    n = len(histories)
    seq = np.zeros((n, L), np.int32)
    seqlen = np.zeros(n, np.int32)
    for i, h in enumerate(histories):
        h = h[-L:]
        seq[i, : len(h)] = h
        seqlen[i] = len(h)
    # the JAX trainer's eval: pre-pad the batch, encode, mask the history, top-k
    batch = jax_pre_pad_batch({"in_item_id": seq, "seqlen": seqlen, "user_hist": seq})
    keep = np.ones(NUM_ITEMS, bool)
    keep[0] = False
    want_s, want_i = (np.asarray(a) for a in rec.topk(
        {"params": params}, to_jax(batch), 5, item_keep_mask=jax.numpy.asarray(keep)))
    port = port_rec(config, NUM_ITEMS, params)
    got_i, got_s = Recommender(port, port.module.state_dict(), batch_size=3,
                               device="cpu").recommend(histories, k=5)
    assert_topk_match(got_i, got_s, want_i, want_s, ATOL)
    # the JAX Recommender right-pads, so it reads a padding position instead
    jax_s = JaxRecommender(rec, params, batch_size=3).recommend(histories, k=5)[1]
    short = seqlen < L
    assert np.abs(np.asarray(jax_s)[short] - want_s[short]).max() > 1e-3
