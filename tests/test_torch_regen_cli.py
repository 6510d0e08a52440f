"""The port's stage CLIs (``dr4sr_tpu_torch/scripts/``) through ``runpy``
on a tiny synthetic dataset, on the CPU:

* stage 1 writes the same ``patterns.npz`` and ``seq-pat-pair.pkl`` as the
  JAX package's ``scripts/build_pretraining_dataset.py``;
* stage 2 writes a regenerator checkpoint that loads;
* stage 3 writes ``train_regen.npz``, keeps the JAX CLI's knobs
  (``--regen_cache``, ``--no_patterns``, ``--min_regen_len``,
  ``--original_repeat``) and takes a JAX regenerator msgpack; then
  ``python -m dr4sr_tpu_torch.run`` trains on ``_regen`` with no new code;
* the fused pipeline runs all stages in one process.
"""

import os
import pickle
import runpy
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dr4sr_tpu.regen.generator import Generator as JaxGenerator
from dr4sr_tpu_torch.data.dataset import load_rows
from dr4sr_tpu_torch.data.synthetic import write_synthetic_dataset
from dr4sr_tpu_torch.train.checkpoint import load_regenerator
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_ITEMS = 30


def run_module(name, *argv):
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_module(f"dr4sr_tpu_torch.scripts.{name}", run_name="__main__")
    finally:
        sys.argv = old


def run_jax_script(name, *argv):
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(REPO, "scripts", name + ".py"), run_name="__main__")
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("regen_cli")
    write_synthetic_dataset(str(base), num_users=40, num_items=NUM_ITEMS, seed=1)
    domain = base / "synthetic" / "syn"
    run_module("build_pretraining_dataset", "--root_path", str(domain), "--alpha", "4",
               "--n_jobs", "2")
    run_module("pretrain_regenerator", "--root_path", str(domain), "--K", "2", "--epochs", "10",
               "--batch_size", "32", "--cpu")
    return base


def test_stage1_writes_what_the_jax_cli_writes(root, tmp_path):
    domain = root / "synthetic" / "syn"
    jax_domain = tmp_path / "syn"
    shutil.copytree(domain, jax_domain)
    run_jax_script("build_pretraining_dataset", "--root_path", str(jax_domain), "--alpha", "4",
                   "--n_jobs", "2", "--patterns_out", "jax_patterns", "--pairs_out", "jax.pkl")
    with np.load(domain / "patterns.npz") as got, np.load(jax_domain / "jax_patterns.npz") as want:
        assert set(got.files) == set(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])
    with open(domain / "seq-pat-pair.pkl", "rb") as f, open(jax_domain / "jax.pkl", "rb") as g:
        pairs = pickle.load(f)
        assert pairs == pickle.load(g) and len(pairs) > 0


def test_stage2_checkpoint_loads(root):
    module = load_regenerator(str(root / "synthetic" / "syn" / "regenerator.pt"), device="cpu")
    assert module.num_items == NUM_ITEMS and module.k == 2 and not module.training


def test_stage3_and_training_on_regen(root):
    domain = root / "synthetic" / "syn"
    run_module("hybrid_inference", "--root_path", str(domain), "--K", "2", "--max_len", "8",
               "--batch_size", "32", "--cpu")
    train = load_rows(str(domain / "train"), True, 50)
    patterns = load_rows(str(domain / "patterns"), True, 50)
    regen = load_rows(str(domain / "train_regen"), True, 50)
    assert len(regen) > len(patterns) > len(train)
    np.testing.assert_array_equal(regen.in_item_id[: len(patterns)], patterns.in_item_id)
    assert (regen.user_id[len(patterns):] == 1).all()  # regenerated rows
    from dr4sr_tpu_torch import run

    out = run.main(["-m", "SASRec", "-d", "synthetic", "--root", str(root), "--train-file",
                    "_regen", "--epochs", "1", "--cpu", "--set", "eval.save_path=" + str(root)])
    assert np.isfinite(out["ndcg@20"])


def test_stage3_cli_minlen_original_repeat_and_a_jax_checkpoint(root, tmp_path):
    """The JAX CLI's test (``tests/test_regen.py``) on the port's CLI, from a
    JAX regenerator msgpack."""
    from flax import serialization

    domain = root / "synthetic" / "syn"
    train = load_rows(str(domain / "train"), True, 50)
    gen = JaxGenerator(num_items=NUM_ITEMS, k=2)
    key = jax.random.PRNGKey(0)
    src0 = jnp.zeros((1, 4), jnp.int32)
    variables = gen.init({"params": key, "dropout": key, "gumbel": key}, src0, src0[:, :-1],
                         jnp.ones(1, jnp.int32), jnp.asarray(1.0))
    (domain / "jax_regen.msgpack").write_bytes(serialization.to_bytes(jax.device_get(variables)))

    def mk(uid, items):
        return [uid, items[:-1], items[1:], len(items) - 1, items[1:], [0] * (len(items) - 1)]

    cache = [mk(i, [3, 4]) for i in range(5)] + [mk(9 + i, [5, 6, 7, 8]) for i in range(3)]
    cache_path = tmp_path / "cache.pkl"
    with open(cache_path, "wb") as f:
        pickle.dump(cache, f)

    def run_cli(*extra):
        run_module("hybrid_inference", "--root_path", str(domain), "--ckpt_name",
                   "jax_regen.msgpack", "--K", "2", "--regen_cache", str(cache_path),
                   "--no_patterns", "--out_name", "_t_out", "--cpu", *extra)
        return load_rows(str(domain / "_t_out"), True, 50)

    assert len(run_cli()) == len(train) + 8
    assert len(run_cli("--min_regen_len", "3")) == len(train) + 3
    assert len(run_cli("--min_regen_len", "3", "--original_repeat", "2")) == 2 * len(train) + 3
    with pytest.raises(SystemExit, match="K=2"):
        run_cli("--K", "3")


@pytest.mark.parametrize("kind", ["port", "jax", "reference"])
def test_load_item_embedding_reads_every_format(tmp_path, kind):
    """``--embedding`` reads the port's SASRec checkpoint, a JAX msgpack and
    a ``torch.save`` file shaped like the reference's ``.ckpt``, as the JAX
    package's ``load_torch_embedding`` reads the last two."""
    import torch
    from flax import serialization

    from dr4sr_tpu.train.checkpoint import load_torch_embedding
    from dr4sr_tpu_torch.train.checkpoint import load_item_embedding, save_checkpoint

    table = np.random.default_rng(5).normal(size=(NUM_ITEMS, 16)).astype(np.float32)
    path = str(tmp_path / f"{kind}.ckpt")
    if kind == "port":
        save_checkpoint(path, {"item_embedding.weight": torch.from_numpy(table),
                               "position_emb.weight": torch.zeros(50, 16)}, {}, "SASRec", 0, {})
    elif kind == "jax":
        tree = {"params": {"encoder": {}, "item_embedding": {"embedding": table}}}
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(tree))
    else:
        torch.save({"parameters": {"item_embedding.weight": torch.from_numpy(table)}}, path)
    got = load_item_embedding(path)
    np.testing.assert_array_equal(got, table)
    if kind != "port":
        np.testing.assert_array_equal(got, load_torch_embedding(path))


def test_fused_pipeline(root, tmp_path, monkeypatch):
    from dr4sr_tpu_torch.scripts import fused_pipeline

    monkeypatch.chdir(tmp_path)  # the config's save_path is ./saved/
    base = tmp_path / "fused"
    write_synthetic_dataset(str(base), num_users=40, num_items=NUM_ITEMS, seed=2)
    out = fused_pipeline.main(["--dataset", "synthetic", "--root", str(base), "--alpha", "4",
                               "--K", "2", "--regen-epochs", "1", "--train-epochs", "1",
                               "--max-len", "8", "--decode-batch", "64", "--cpu"])
    assert out["regen_rows"] > 0 and out["pattern_rows"] > 0 and out["device"] == "cpu"
    assert out["train_rows_fused"] > out["pattern_rows"] + out["regen_rows"]
    assert np.isfinite(out["test"]["ndcg@20"])
