"""The port's data layer and rank metrics against the JAX package: the
synthetic writer's files, the dataset rows, the loader's batches (bit for
bit, padded last batch included) and the metrics on random hit matrices
(atol 1e-6)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu import evaluation as jax_evaluation
from dr4sr_tpu.data.dataset import _load_meta as jax_load_meta
from dr4sr_tpu.data.dataset import load_rows as jax_load_rows
from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.synthetic import synthetic_config
from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu_torch import evaluation
from dr4sr_tpu_torch.data.dataset import (
    SeqDataset,
    _load_meta,
    get_dataset_class,
    load_rows,
    prepare_datasets,
)
from dr4sr_tpu_torch.data.synthetic import write_synthetic_dataset

ROWS_FIELDS = ("user_id", "in_item_id", "item_id", "seqlen", "label", "domain_id", "user_hist")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    ours = str(tmp_path_factory.mktemp("port_data"))
    theirs = str(tmp_path_factory.mktemp("jax_data"))
    assert write_synthetic_dataset(ours, num_users=150, num_items=60, seed=3) == \
        jax_write(theirs, num_users=150, num_items=60, seed=3)
    return ours, theirs


def test_synthetic_files_equal_the_jax_writer(roots):
    ours, theirs = (os.path.join(r, "synthetic", "syn") for r in roots)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in os.listdir(ours):
        with np.load(os.path.join(ours, name)) as a, np.load(os.path.join(theirs, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for key in a.files:
                assert a[key].dtype == b[key].dtype, (name, key)
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name}:{key}")


def _assert_rows_equal(a, b):
    for field in ROWS_FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            assert x is None and y is None, field
            continue
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def test_datasets_and_batches_equal_the_jax_ones(roots):
    root = roots[0]
    config = synthetic_config()
    config["train"]["batch_size"] = 64  # 150 rows: the last batch is padded
    ours = prepare_datasets(config, root=root)
    theirs = jax_prepare_datasets(config, root=root)
    for a, b in zip(ours, theirs):
        assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
        _assert_rows_equal(a.rows(), b.rows())
        np.testing.assert_array_equal(a.domain_item_mask("syn"), b.domain_item_mask("syn"))
    for epoch in (0, 1):
        got = list(ours[0].get_loader(seed=epoch))
        want = list(theirs[0].get_loader(seed=epoch))
        assert len(got) == len(want) == 3
        assert not got[-1]["valid"].all()  # the padded last batch
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in g:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    for g, w in zip(ours[1].get_loader(), theirs[1].get_loader()):  # eval: no shuffle
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_reference_pth_rows_and_inter_csv_meta(tmp_path):
    """The reference's .pth row lists and the inter.csv meta fallback."""
    rng = np.random.default_rng(0)
    train_rows, eval_rows = [], []
    for u in range(1, 6):
        n = int(rng.integers(1, 8))
        seq = rng.integers(1, 30, size=n).tolist()
        train_rows.append([u, seq, rng.integers(1, 30, size=n).tolist(), n, [1] * n, [0] * n])
        eval_rows.append([u, seq, int(rng.integers(1, 30)), n, 1, 0])
    dom = tmp_path / "ds" / "d0"
    dom.mkdir(parents=True)
    torch.save(train_rows, dom / "train.pth")
    torch.save(eval_rows, dom / "val.pth")
    with open(dom / "inter.csv", "w") as f:
        f.write("user_id,item_id,timestamp\n")
        for u, seq, *_ in train_rows:
            f.writelines(f"{u},{i},0\n" for i in seq)
    for phase, is_train in (("train", True), ("val", False)):
        _assert_rows_equal(load_rows(str(dom / phase), is_train, 6),
                           jax_load_rows(str(dom / phase), is_train, 6))
    ours = _load_meta(str(tmp_path), "ds", ["d0"])
    theirs = jax_load_meta(str(tmp_path), "ds", ["d0"])
    assert (ours["num_users"], ours["num_items"]) == (theirs["num_users"], theirs["num_items"])
    np.testing.assert_array_equal(ours["domain_items"]["d0"], theirs["domain_items"]["d0"])
    np.testing.assert_array_equal(ours["domain_users"]["d0"], theirs["domain_users"]["d0"])


@pytest.mark.parametrize("name", ["pattern", "condense", "split", "selection", "mix", "bogus"])
def test_unported_dataset_classes_are_refused(name):
    """The five ablation classes are ported: dispatch returns each. A name
    with no class is still refused."""
    if name == "bogus":
        with pytest.raises(NotImplementedError, match="bogus"):
            get_dataset_class({"data": {"dataset_class": name}})
        return
    cls = get_dataset_class({"data": {"dataset_class": name}})
    assert cls.__module__ == "dr4sr_tpu_torch.data.dataset"
    assert cls.__name__ == f"{name.capitalize()}Dataset" and issubclass(cls, SeqDataset)


@pytest.mark.parametrize("target_cols", [None, 3])
def test_rank_metrics_match_jax(target_cols):
    rng = np.random.default_rng(5)
    pred = rng.random((32, 100)) < 0.05
    pred[0] = False  # a row with no hit
    if target_cols is None:
        target = np.ones(32, np.float32)
    else:
        target = (rng.random((32, target_cols)) < 0.7).astype(np.float32)
        target[1] = 0.0  # all irrelevant
    names = ["recall", "precision", "f1", "ndcg", "mrr", "hit", "map", "auc"]
    cutoffs = [20, 10, 5]
    want = jax_evaluation.compute_rank_metrics(jnp.asarray(pred), jnp.asarray(target), names,
                                               cutoffs)
    got = evaluation.compute_rank_metrics(torch.from_numpy(pred), torch.from_numpy(target),
                                          names, cutoffs)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-6,
                                   err_msg=key)
