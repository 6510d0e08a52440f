"""The port's SASRec serving slice against the JAX package on the same weights:
the encoder, masked top-k, and ``Recommender`` end to end on the CPU route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.config import load_config as jax_load_config
from dr4sr_tpu.data.synthetic import markov_sequences, synthetic_config
from dr4sr_tpu.models.base import RecModel as JaxRecModel
from dr4sr_tpu.models.sasrec import SASRec as JaxSASRec
from dr4sr_tpu.ops.topk import masked_topk_scores as jax_topk
from dr4sr_tpu.serve import Recommender as JaxRecommender
from dr4sr_tpu_torch import serve
from dr4sr_tpu_torch.config import load_config
from dr4sr_tpu_torch.convert import sasrec_params_from_jax
from dr4sr_tpu_torch.data import synthetic as port_synthetic
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.ops.topk import masked_topk_scores

NUM_ITEMS = 40
L = 12


def _config():
    config = synthetic_config(max_seq_len=L)
    config["model"].update(embed_dim=16, hidden_size=32, head_num=2, layer_num=2)
    return config


@pytest.fixture(scope="module")
def models():
    """(JAX RecModel, its numpy params, port RecModel with the same weights)."""
    config = _config()
    jax_rec = JaxRecModel(config, JaxSASRec.build(config, NUM_ITEMS), NUM_ITEMS, 1)
    sample = {"in_item_id": np.zeros((1, L), np.int32), "seqlen": np.ones(1, np.int32),
              "item_id": np.zeros(1, np.int32)}
    params = jax.tree_util.tree_map(
        np.asarray, jax_rec.init(jax.random.PRNGKey(0), sample)["params"])
    module = SASRec.build(config, NUM_ITEMS)
    module.load_state_dict(sasrec_params_from_jax(params, module))
    return jax_rec, params, RecModel(config, module, NUM_ITEMS, 1)


def _batch(seed):
    rng = np.random.default_rng(seed)
    seqlen = np.array([L, 5, 1, 9])
    seq = rng.integers(1, NUM_ITEMS, size=(4, L))
    seq[np.arange(L)[None, :] >= seqlen[:, None]] = 0
    return {"in_item_id": seq, "seqlen": seqlen,
            "input_weight": rng.random(size=(4, L)).astype(np.float32)}


@pytest.mark.parametrize("input_weight", [False, True])
@pytest.mark.parametrize("need_pooling", [True, False])
def test_sasrec_encoder_matches_flax(models, need_pooling, input_weight):
    jax_rec, params, rec = models
    batch = _batch(0)
    if not input_weight:
        del batch["input_weight"]
    want = jax_rec.module.apply({"params": params}, jax.tree_util.tree_map(jnp.asarray, batch),
                                training=False, need_pooling=need_pooling)
    with torch.no_grad():
        got = rec.module.eval()({k: torch.from_numpy(v) for k, v in batch.items()},
                                need_pooling=need_pooling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_masked_topk_matches_jax(method):
    rng = np.random.default_rng(0)
    query = rng.normal(size=(4, 8)).astype(np.float32)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    keep = np.ones(64, bool)
    keep[0] = False
    keep[10:20] = False
    hist = np.zeros((4, 5), np.int64)
    hist[:, 0] = 3
    hist[1, 1] = 30
    hist[2, 2] = 99  # outside the catalog: ignored
    want_s, want_i = jax_topk(*map(jnp.asarray, (query, table)), 8,
                              jnp.asarray(keep), jnp.asarray(hist), method=method)
    got_s, got_i = masked_topk_scores(*map(torch.from_numpy, (query, table)), 8,
                                      torch.from_numpy(keep), torch.from_numpy(hist),
                                      method=method)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _histories():
    rng = np.random.default_rng(3)
    hs = [[], [7], list(rng.integers(1, NUM_ITEMS, size=2 * L))]  # empty, short, longer than L
    hs += [list(rng.integers(1, NUM_ITEMS, size=n)) for n in (3, L, 4, 8)]
    return hs  # 7 histories: not a multiple of the batch size


def _separated(scores, tol):
    """Positions whose neighbours in the ranked row differ by more than tol."""
    gap = np.abs(np.diff(scores, axis=1)) > tol
    ok = np.ones(scores.shape, bool)
    ok[:, 1:] &= gap
    ok[:, :-1] &= gap
    ok[:, -1] = False  # its next neighbour lies outside the top k
    return ok


@pytest.mark.parametrize("keep_mask", [False, True])
@pytest.mark.parametrize("exclude_seen", [True, False])
def test_recommender_matches_jax(models, exclude_seen, keep_mask):
    jax_rec, params, rec = models
    keep = np.arange(NUM_ITEMS) % 5 != 2 if keep_mask else None
    want_i, want_s = JaxRecommender(jax_rec, params, item_keep_mask=keep, batch_size=4).recommend(
        _histories(), k=6, exclude_seen=exclude_seen)
    server = serve.Recommender(rec, rec.module.state_dict(), item_keep_mask=keep, batch_size=4,
                               device="cpu")
    got_i, got_s = server.recommend(_histories(), k=6, exclude_seen=exclude_seen)
    assert got_i.dtype == np.int64 and got_s.dtype == np.float32
    np.testing.assert_allclose(got_s, want_s, atol=1e-5)
    sep = _separated(want_s, 1e-5)
    assert sep.any()
    np.testing.assert_array_equal(got_i[sep], want_i[sep])


def test_recommender_k_above_catalog_returns_every_eligible_item(models):
    rec = models[2]
    server = serve.Recommender(rec, rec.module.state_dict(), batch_size=4, device="cpu")
    items, scores = server.recommend([[1, 2, 3], []], k=NUM_ITEMS + 5, exclude_seen=True)
    assert items.shape == scores.shape == (2, NUM_ITEMS)
    # PAD and the 3 seen items rank last, at the mask value
    assert set(items[0, -4:].tolist()) == {0, 1, 2, 3}
    assert (scores[0, -4:] < -1e29).all() and (scores[0, :-4] > -1e29).all()


def test_recommender_refuses_cuda_without_a_card(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = models[2]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.Recommender(rec, rec.module.state_dict())


def test_copied_helpers_match_jax():
    assert load_config("SASRec", "amazon-toys") == jax_load_config("SASRec", "amazon-toys")
    assert port_synthetic.synthetic_config() == synthetic_config()
    assert port_synthetic.markov_sequences(num_users=20, seed=4) == markov_sequences(
        num_users=20, seed=4)


def test_convert_uses_every_key(models):
    _, params, rec = models
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="no counterpart"):
        sasrec_params_from_jax(extra, rec.module)
    short = {k: v for k, v in params.items() if k != "position_emb"}
    with pytest.raises(ValueError, match="no JAX param"):
        sasrec_params_from_jax(short, rec.module)
