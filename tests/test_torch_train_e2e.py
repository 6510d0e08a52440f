"""End to end on the CPU: the port trains SASRec on synthetic data with
``Trainer(device="cpu")`` to the quality bands of tests/test_train_e2e.py,
checkpoints, resumes, stops early, serves from its own and from a JAX
checkpoint, and runs as a CLI."""

import copy
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dr4sr_tpu.models.base import RecModel as JaxRecModel
from dr4sr_tpu.models.sasrec import SASRec as JaxSASRec
from dr4sr_tpu.serve import Recommender as JaxRecommender
from dr4sr_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu_torch.serve import Recommender
from dr4sr_tpu_torch.train.callbacks import EarlyStopping
from dr4sr_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from dr4sr_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HISTORIES = [[1, 2, 3], [5, 6], [10], [], list(range(1, 60))]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("port_e2e_data"))
    write_synthetic_dataset(path, num_users=300, num_items=80, seed=1)
    return path


def _config(**train):
    cfg = synthetic_config()
    cfg["train"]["epochs"] = 3
    cfg["model"]["dropout_rate"] = 0.1
    cfg["train"].update(train)
    return cfg


@pytest.fixture(scope="module")
def trained(root, tmp_path_factory):
    cfg = _config()
    trainer = Trainer(cfg, prepare_datasets(cfg, root=root),
                      workdir=str(tmp_path_factory.mktemp("port_e2e_workdir")), device="cpu")
    trainer.fit()
    return trainer


def test_loss_decreases(trained):
    assert trained.logged_metrics["train_loss"] < 1.4  # ~2·ln 2 at init


def test_validation_beats_random(trained):
    # random recall@20 on an ~80-item catalog would be ~0.25
    assert trained.logged_metrics["recall@20"] > 0.3
    assert trained.logged_metrics["ndcg@20"] > 0.1


def test_metrics_jsonl_has_every_epoch(trained):
    path = os.path.join(trained.workdir, "SASRec", "synthetic", "metrics.jsonl")
    with open(path) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in records)


def test_evaluate_returns_both_cutoffs(trained):
    out = trained.evaluate()
    for key in ("ndcg@20", "ndcg@10", "recall@20", "recall@10"):
        assert 0.0 <= out[key] <= 1.0
    assert out["recall@20"] >= out["recall@10"]


def test_checkpoint_roundtrip(trained, tmp_path):
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, trained.best_params, trained.config, "SASRec", 1, {"ndcg@20": 0.5})
    params, meta = load_checkpoint(path)
    assert meta["model"] == "SASRec" and meta["epoch"] == 1
    assert meta["metric"] == {"ndcg@20": 0.5} and meta["config"] == trained.config
    with open(path + ".json") as f:
        assert json.load(f)["model"] == "SASRec"
    assert params.keys() == trained.best_params.keys()
    for k, v in params.items():
        assert torch.equal(v, trained.best_params[k])
    trained.load_best_from(path)


def test_best_checkpoint_is_written(trained):
    params, meta = load_checkpoint(trained.callback.checkpoint_path)
    assert meta["epoch"] == trained.callback.best_epoch
    for k, v in params.items():
        assert torch.equal(v, trained.best_params[k])


def test_resume_from_snapshot(root, tmp_path):
    """Preemption recovery: the snapshot restores params, optimizer, step,
    epoch and generators."""
    cfg = _config(epochs=2, checkpoint_every_epochs=1)
    t1 = Trainer(cfg, prepare_datasets(cfg, root=root), workdir=str(tmp_path), device="cpu")
    t1.fit()
    cfg2 = _config(epochs=3, checkpoint_every_epochs=1)
    t2 = Trainer(cfg2, prepare_datasets(cfg2, root=root), workdir=str(tmp_path), device="cpu")
    t2.init_state()
    assert t2.restore_train_state() == 2  # the epoch after the snapshot at epoch 1
    assert t2.step == t1.step
    for (name, a), b in zip(t1.rec.module.state_dict().items(),
                            t2.rec.module.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(t1.generator.get_state(), t2.generator.get_state())
    t3 = Trainer(copy.deepcopy(cfg2), prepare_datasets(cfg2, root=root), workdir=str(tmp_path),
                 device="cpu")
    t3.fit(resume=True)
    assert t3.logged_metrics["epoch"] == 2


def test_plateau_resets_early_stopping():
    """Reference semantics (utils/callbacks.py:98,106): a tied metric counts
    as improvement — patience resets and the checkpoint epoch advances."""
    cb = EarlyStopping("ndcg@20", "ds", "M", save_dir=None, patience=3)
    params = {"w": torch.zeros(1)}
    assert not cb(params, {}, 0, {"ndcg@20": 0.5})
    assert [cb(params, {}, i, {"ndcg@20": 0.5}) for i in range(1, 4)] == [False] * 3
    assert cb.best_epoch == 3
    assert [cb(params, {}, 4 + i, {"ndcg@20": 0.4}) for i in range(3)] == [False, False, True]


def test_recommender_from_port_checkpoint(trained, root, tmp_path):
    path = str(tmp_path / "serve.ckpt")
    save_checkpoint(path, trained.best_params, trained.config, "SASRec", 1, {"ndcg@20": 0.5})
    server = Recommender.from_checkpoint(path, root=root, batch_size=4, device="cpu")
    items, scores = server.recommend(HISTORIES, k=5)
    want_i, want_s = Recommender(trained.rec, trained.best_params, batch_size=4,
                                 device="cpu").recommend(HISTORIES, k=5)
    np.testing.assert_array_equal(items, want_i)
    np.testing.assert_array_equal(scores, want_s)
    for h, row in zip(HISTORIES, items):  # the last max_seq_len items count as seen
        assert 0 not in row and not set(h[-50:]) & set(row.tolist())


def test_recommender_from_jax_checkpoint(root, tmp_path):
    """A checkpoint written by the JAX package serves the same top-k."""
    config = synthetic_config()
    jax_rec = JaxRecModel(config, JaxSASRec.build(config, 80), 80, 301)
    sample = {"in_item_id": np.zeros((1, 50), np.int32), "seqlen": np.ones(1, np.int32),
              "item_id": np.zeros(1, np.int32)}
    params = jax_rec.init(jax.random.PRNGKey(7), sample)["params"]
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, params, config, "SASRec", 3, {"ndcg@20": 0.1})
    want_i, want_s = JaxRecommender.from_checkpoint(path, root=root, batch_size=4).recommend(
        HISTORIES, k=5)
    got_i, got_s = Recommender.from_checkpoint(path, root=root, batch_size=4,
                                               device="cpu").recommend(HISTORIES, k=5)
    np.testing.assert_allclose(got_s, want_s, atol=1e-5)
    apart = np.abs(np.diff(want_s, axis=1)) > 1e-5  # neighbours that are not near-ties
    sep = np.ones(want_s.shape, bool)
    sep[:, 1:] &= apart
    sep[:, :-1] &= apart
    sep[:, -1] = False
    np.testing.assert_array_equal(got_i[sep], want_i[sep])


def test_cli_trains_one_epoch_on_the_cpu(root, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "dr4sr_tpu_torch.run", "--cpu", "-m", "SASRec", "-d", "synthetic",
         "--root", root, "--epochs", "1", "--set", f"eval.save_path={tmp_path}"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "'ndcg@20'" in proc.stdout.splitlines()[-1]
    assert os.path.exists(tmp_path / "SASRec" / "synthetic" / "metrics.jsonl")


def test_bf16_mixed_precision_training(root, tmp_path):
    """train.precision: bf16 — forward and backward under autocast, f32
    master weights; the same quality band as the JAX bf16 test."""
    cfg = _config(precision="bf16")
    trainer = Trainer(cfg, prepare_datasets(cfg, root=root), workdir=str(tmp_path), device="cpu")
    trainer.fit()
    assert all(p.dtype == torch.float32 for p in trainer.rec.module.parameters())
    assert np.isfinite(trainer.logged_metrics["train_loss"])
    assert trainer.logged_metrics["train_loss"] < 1.4
    assert trainer.logged_metrics["recall@20"] > 0.3


@pytest.mark.parametrize("train, error", [
    # CL4SRec's item_random views pick on the host: its step cannot be captured
    ({"steps_per_dispatch": 4, "model": "CL4SRec"}, NotImplementedError),
    # it chooses JAX's PRNG implementation; the port draws from torch generators
    ({"rng_impl": "rbg"}, NotImplementedError),
    ({"precision": "fp16"}, ValueError),
])
def test_unported_options_are_refused(root, train, error):
    train = dict(train)
    model = train.pop("model", "SASRec")
    cfg = _config(**train)
    cfg["model"]["model"] = model
    with pytest.raises(error):
        Trainer(cfg, prepare_datasets(cfg, root=root), device="cpu")


def test_the_card_is_the_default_device(root):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    cfg = _config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, prepare_datasets(cfg, root=root))
