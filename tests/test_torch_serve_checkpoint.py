"""Serving a checkpoint whose item table an EP run saved padded.

An EP trainer saves the item table padded to a multiple of the ``model``
axis (62 rows for a 61-item catalog at EP 1 × 2), as the JAX trainer's
``device_get`` does. ``Recommender.from_checkpoint`` cuts it to the
catalog's rows before loading, for a checkpoint of this package as for a
JAX one, and serves the same items as the same weights cut by hand. (The
JAX ``Recommender`` fails on such a file, at its first ``recommend``; the
JAX package is the reference and is left as it is.) A table with fewer rows
than the catalog is still refused.
"""

import copy
import glob
import os

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from dr4sr_tpu.models.base import RecModel as JaxRecModel
from dr4sr_tpu.models.sasrec import SASRec as JaxSASRec
from dr4sr_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.serve import Recommender
from dr4sr_tpu_torch.train.checkpoint import load_checkpoint, load_item_embedding, save_checkpoint
from torch_dist_parity import BATCH, NUM_ITEMS
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

TABLE = "item_embedding.weight"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_ckpt"))
    write_synthetic_dataset(root, num_users=120, num_items=NUM_ITEMS, seed=6)
    cfg = synthetic_config()
    cfg["model"].update(embed_dim=16, hidden_size=32, dropout_rate=0.0)
    cfg["train"].update(batch_size=BATCH, epochs=1)
    cfg["eval"]["topk"] = 20
    return root, cfg


@pytest.fixture(scope="module")
def ep_checkpoint(setup, tmp_path_factory):
    """The best checkpoint of ``fit`` at EP 1 × 2 (process 0 writes it)."""
    root, cfg = setup
    tmp = tmp_path_factory.mktemp("ep_fit")
    workdir = str(tmp / "saved")
    w.run_ranks(w.fit_and_reload, 2, tmp, cfg, root, 1, 2, workdir)
    (path,) = glob.glob(os.path.join(workdir, "SASRec", "synthetic", "*.ckpt"))
    return path


def _histories(root):
    cfg = synthetic_config()
    rows = prepare_datasets(cfg, root=root)[2].rows()
    hists = [list(r[:n]) for r, n in zip(rows.in_item_id, rows.seqlen)][:70]
    return hists + [[], [1], list(range(1, 60))]


def _by_hand(config, params):
    """A ``Recommender`` on the checkpoint's weights, table cut by hand."""
    module = SASRec.build(config, NUM_ITEMS)
    params = {k: v[:NUM_ITEMS] if k == TABLE else v for k, v in params.items()}
    return Recommender(RecModel(config, module, NUM_ITEMS, 0), params, device="cpu")


def test_an_ep_checkpoint_serves_as_its_cut_table(setup, ep_checkpoint):
    root, _ = setup
    params, meta = load_checkpoint(ep_checkpoint)
    assert params[TABLE].shape[0] == 62  # padded to a multiple of 2
    served = Recommender.from_checkpoint(ep_checkpoint, root=root, device="cpu")
    assert served.rec.module.item_embedding.weight.shape[0] == NUM_ITEMS
    hists = _histories(root)
    items, scores = served.recommend(hists, k=10)
    want_items, want_scores = _by_hand(meta["config"], params).recommend(hists, k=10)
    np.testing.assert_array_equal(items, want_items)
    np.testing.assert_array_equal(scores, want_scores)
    assert (items > 0).all() and (items < NUM_ITEMS).all()


def _padded(tree):
    """A JAX param tree with its item table padded by one zero row."""
    out = {}
    for key, value in tree.items():
        if key == "item_embedding":
            table = value["embedding"]
            value = {"embedding": np.concatenate([table, np.zeros_like(table[:1])])}
        elif isinstance(value, dict):
            value = _padded(value)
        out[key] = value
    return out


def test_a_padded_jax_checkpoint_serves_as_its_cut_table(setup, tmp_path):
    """A JAX checkpoint (flax msgpack and sidecar) of the same weights with
    the table padded by a row serves what the unpadded one serves
    (``convert.params_from_jax`` cuts it)."""
    root, cfg = setup
    config = copy.deepcopy(cfg)
    jax_rec = JaxRecModel(config, JaxSASRec.build(config, NUM_ITEMS), NUM_ITEMS, 121)
    sample = {"in_item_id": np.zeros((1, 50), np.int32), "seqlen": np.ones(1, np.int32),
              "item_id": np.zeros(1, np.int32)}
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_rec.init(jax.random.PRNGKey(3), sample)["params"])
    hists = _histories(root)
    served = []
    for name, tree in (("plain", params), ("padded", _padded(params))):
        path = str(tmp_path / f"{name}.ckpt")
        jax_save_checkpoint(path, tree, config, "SASRec", 0, {})
        assert load_item_embedding(path).shape[0] == NUM_ITEMS + (name == "padded")
        served.append(Recommender.from_checkpoint(path, root=root, device="cpu")
                      .recommend(hists, k=10))
    np.testing.assert_array_equal(served[0][0], served[1][0])
    np.testing.assert_array_equal(served[0][1], served[1][1])


def test_a_table_with_fewer_rows_is_refused(setup, ep_checkpoint, tmp_path):
    root, _ = setup
    params, meta = load_checkpoint(ep_checkpoint)
    params = dict(params, **{TABLE: params[TABLE][: NUM_ITEMS - 1].clone()})
    path = str(tmp_path / "short.ckpt")
    save_checkpoint(path, params, copy.deepcopy(meta["config"]), "SASRec", 0, {})
    with pytest.raises(RuntimeError, match="size mismatch"):
        Recommender.from_checkpoint(path, root=root, device="cpu")


def test_the_table_is_cut_without_touching_the_callers_params(setup, ep_checkpoint):
    params, meta = load_checkpoint(ep_checkpoint)
    config = meta["config"]
    module = SASRec.build(config, NUM_ITEMS)
    before = params[TABLE].clone()
    Recommender(RecModel(config, module, NUM_ITEMS, 0), params, device="cpu")
    assert torch.equal(params[TABLE], before) and before.shape[0] == 62
