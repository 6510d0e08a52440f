"""The port's ablation dataset classes, loader options and numpy-typed
``.pth`` files against the JAX package, element for element (host numpy
only, so no tolerance):

* each of ``pattern`` (every mode), ``condense``, ``split``, ``selection``
  and ``mix`` builds the same train rows as ``dr4sr_tpu.data.dataset``, and
  the cases of ``tests/test_dataset_variants.py`` hold for the port;
* ``get_loader(pad_to_full=False)`` and ``drop_last=True`` give JAX's batches;
* ``.pth`` files holding numpy scalars and arrays load with
  ``weights_only=True`` (``serialization.load_with_numpy``) into what the
  JAX loaders read with ``weights_only=False``.
"""

import copy
import io
import os
import shutil

import numpy as np
import pytest
import torch

from dr4sr_tpu.data import dataset as jax_dataset
from dr4sr_tpu.data.loader import BatchIterator as JaxBatchIterator
from dr4sr_tpu.data.synthetic import synthetic_config
from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu_torch.data import dataset
from dr4sr_tpu_torch.scripts.build_pretraining_dataset import load_seq2pat
from dr4sr_tpu_torch.serialization import load_with_numpy
from dr4sr_tpu_torch.train.checkpoint import load_item_embedding

FIELDS = ("user_id", "in_item_id", "item_id", "seqlen", "label", "domain_id", "user_hist")
CLASSES = ("general", "pattern", "condense", "split", "selection", "mix")


def _assert_rows_equal(a, b):
    assert len(a) == len(b)
    for field in FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            assert x is None and y is None, field
            continue
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("variants"))
    jax_write(path, num_users=100, num_items=60, seed=6)
    # the mixed train file of the 'mix' class, at <root>/<name>/
    shutil.copy(os.path.join(path, "synthetic", "syn", "train.npz"),
                os.path.join(path, "synthetic", "train.npz"))
    return path


def _config(key, train_file=""):
    cfg = copy.deepcopy(synthetic_config())
    cfg["data"]["dataset_class"] = key
    cfg["data"]["train_file"] = train_file
    return cfg


@pytest.mark.parametrize("key", CLASSES)
def test_rows_equal_the_jax_classes(root, key):
    cfg = _config(key, "_ori" if key == "pattern" else "")
    ours = dataset.prepare_datasets(cfg, root=root)
    theirs = jax_dataset.prepare_datasets(cfg, root=root)
    assert type(ours[0]).__name__ == type(theirs[0]).__name__
    for a, b in zip(ours, theirs):
        _assert_rows_equal(a.rows(), b.rows())
    if key == "pattern":
        for mode in ("pattern", "all", "original"):
            ours[0].set_mode(mode)
            theirs[0].set_mode(mode)
            _assert_rows_equal(ours[0].rows(), theirs[0].rows())


def _train(root, key, train_file=""):
    return dataset.prepare_datasets(_config(key, train_file), root=root)[0]


def test_condense_packs_sequences(root):
    rows, base = _train(root, "condense").rows(), _train(root, "general").rows()
    assert len(rows) <= len(base)
    assert rows.seqlen.sum() == base.seqlen.sum()
    assert (rows.seqlen <= 50).all()
    for i in range(len(rows)):
        n = rows.seqlen[i]
        assert (rows.in_item_id[i][:n] != 0).all() and (rows.in_item_id[i][n:] == 0).all()
    np.testing.assert_array_equal(rows.label, rows.in_item_id != 0)


def test_selection_halves(root):
    assert len(_train(root, "selection")) == len(_train(root, "general")) // 2


def test_split_splits_long_rows(root):
    rows, base = _train(root, "split").rows(), _train(root, "general").rows()
    assert rows.seqlen.sum() == base.seqlen.sum()
    assert len(rows) > len(base)  # seed 6 has rows of at least 26 items
    np.testing.assert_array_equal(rows.label, np.arange(50)[None, :] < rows.seqlen[:, None])


def test_pattern_modes(root):
    train = _train(root, "pattern", "_ori")
    n_ori, n_pat = len(train._data), len(train._pattern_data)
    for mode, n in (("original", n_ori), ("pattern", n_pat), ("all", n_ori + n_pat)):
        train.set_mode(mode)
        assert train.mode == mode and len(train) == n
    with pytest.raises(NotImplementedError):
        train.set_mode("bogus")


@pytest.mark.parametrize("pad_to_full, drop_last", [(False, False), (True, True), (False, True)])
def test_loader_options_equal_the_jax_loader(root, pad_to_full, drop_last):
    cfg = _config("general")
    ours = dataset.prepare_datasets(cfg, root=root)[0]
    theirs = jax_dataset.prepare_datasets(cfg, root=root)[0]
    kw = dict(seed=3, pad_to_full=pad_to_full, drop_last=drop_last)
    got = list(ours.get_loader(batch_size=32, **kw))
    want = list(JaxBatchIterator(theirs.rows(), 32, shuffle=True, **kw))
    n_batches = 3 if drop_last else 4
    assert len(got) == len(want) == len(ours.get_loader(batch_size=32, **kw)) == n_batches
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if not (pad_to_full or drop_last):
        assert len(got[-1]["user_id"]) == 100 - 3 * 32


def _numpy_rows(is_train):
    """Reference-style row lists whose values are numpy scalars and arrays."""
    rng = np.random.default_rng(1)
    rows = []
    for u in range(1, 7):
        n = int(rng.integers(1, 9))
        seq = rng.integers(1, 40, size=n)
        if is_train:
            rows.append([np.int64(u), seq, rng.integers(1, 40, size=n), np.int64(n),
                         np.ones(n, np.float32), np.zeros(n, np.int64)])
        else:
            rows.append([np.int64(u), seq, np.int64(rng.integers(1, 40)), np.int32(n),
                         np.float32(1.0), np.int64(0)])
    return rows


@pytest.mark.parametrize("is_train", [True, False])
def test_numpy_typed_pth_rows_load_as_jax_loads_them(tmp_path, is_train):
    path = str(tmp_path / "rows")
    torch.save(_numpy_rows(is_train), path + ".pth")
    with pytest.raises(Exception):  # what the allow-list repairs
        torch.load(path + ".pth", weights_only=True)
    _assert_rows_equal(dataset.load_rows(path, is_train, 6),
                       jax_dataset.load_rows(path, is_train, 6))


def test_numpy1_names_are_allowed():
    """A file pickled under numpy 1 names ``numpy.core.multiarray``."""
    buf = io.BytesIO()
    torch.save([np.int64(3), np.arange(4)], buf, _use_new_zipfile_serialization=False)
    old = buf.getvalue().replace(b"numpy._core.multiarray", b"numpy.core.multiarray")
    got = load_with_numpy(io.BytesIO(old))
    assert got[0] == 3 and got[0].dtype == np.int64
    np.testing.assert_array_equal(got[1], np.arange(4))


def test_numpy_seq2pat_and_item_embedding(tmp_path):
    seqs = [np.array([1, 2, 3]), np.array([4, 5])]
    torch.save(seqs, tmp_path / "seq2pat_data.pth")
    assert load_seq2pat(str(tmp_path)) == [[1, 2, 3], [4, 5]]
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    torch.save({"parameters": {"item_embedding.weight": torch.from_numpy(table)},
                "epoch": np.int64(3), "metric": {"ndcg@20": np.float64(0.5)}},
               tmp_path / "ref.ckpt")
    np.testing.assert_array_equal(load_item_embedding(str(tmp_path / "ref.ckpt")), table)
