"""The model zoo end to end on the CPU: ``Trainer(device="cpu").fit()`` of
GRU4Rec, FMLP, CL4SRec, CL4SRec2, GNN, SGL, SimGCL, NCL and ICLRec on a
small synthetic set, 2 epochs (CL4SRec's 3: its contrastive term is noisy
over few steps): a falling loss, finite metrics that beat random, their
bf16 steps, the CLI ``python -m dr4sr_tpu_torch.run --cpu -m <model>``
with the shipped configs, FMLP's prefix rows in the trainer, NCL's and
ICLRec's state refreshed once an epoch, the refusal of
``model.context_parallel > 1``, and DR4SR+'s ``MetaModel`` refused by a
plain ``Trainer`` and given its own by ``make_trainer``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQUENTIAL = ("GRU4Rec", "FMLP", "CL4SRec", "CL4SRec2")
GRAPH_AND_INTENT = ("GNN", "SGL", "SimGCL", "NCL", "ICLRec")
MODELS = SEQUENTIAL + GRAPH_AND_INTENT
NUM_ITEMS = 60


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("zoo_data"))
    write_synthetic_dataset(path, num_users=400, num_items=NUM_ITEMS, max_seq_len=20, seed=4)
    return path


def _config(model, **train):
    cfg = synthetic_config(model_name=model, max_seq_len=20,
                           train_file="_ori" if model == "CL4SRec2" else "")
    cfg["model"].update(embed_dim=32, hidden_size=64, dropout_rate=0.1, num_clusters=8,
                        num_intent_clusters=4)
    cfg["train"].update({"epochs": 2, "batch_size": 32, **train})
    return cfg


@pytest.mark.parametrize("model", MODELS)
def test_fit_two_epochs(root, tmp_path, model):
    epochs = 3 if model.startswith("CL4SRec") else 2
    cfg = _config(model, learning_rate=3e-3, epochs=epochs)
    trainer = Trainer(cfg, prepare_datasets(cfg, root=root), workdir=str(tmp_path), device="cpu")
    trainer.fit()
    with open(os.path.join(trainer.run_dir(), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in records]
    assert len(losses) == epochs and np.isfinite(losses).all() and losses[-1] < losses[0]
    test = trainer.evaluate()
    assert all(np.isfinite(v) for v in test.values())
    assert trainer.logged_metrics["recall@20"] > 20 / NUM_ITEMS  # above random


@pytest.mark.parametrize("model", MODELS)
def test_bf16_steps(root, tmp_path, model):
    cfg = _config(model, precision="bf16")
    trainer = Trainer(cfg, prepare_datasets(cfg, root=root), workdir=str(tmp_path), device="cpu")
    trainer.init_state()
    trainer.refresh_state(0)  # NCL's and ICLRec's state, as an epoch starts
    losses = [trainer.train_step(trainer.device_batch(b, is_train=True)).item()
              for b, _ in zip(trainer.train_batches(0), range(3))]
    assert np.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in trainer.rec.module.parameters())


def test_fmlp_trains_on_prefix_rows(root):
    cfg = _config("FMLP")
    datasets = prepare_datasets(cfg, root=root)
    n_prefix = int(datasets[0].rows().seqlen.sum())
    trainer = Trainer(cfg, datasets, device="cpu")
    rows = trainer.train_data.rows()
    assert len(rows) == n_prefix and rows.item_id.ndim == 1
    batch = next(iter(trainer.train_batches(0)))
    # prefix rows are pre-padded already: the train batch goes as it is
    assert trainer.host_transform(batch, is_train=True) is batch
    assert (batch["in_item_id"][:, -1] != 0).all()
    val = next(iter(trainer.val_data.get_loader()))
    moved = trainer.host_transform(val)["in_item_id"]
    np.testing.assert_array_equal(moved[np.arange(len(moved)), -1],
                                  val["in_item_id"][np.arange(len(moved)), val["seqlen"] - 1])


@pytest.mark.parametrize("model", SEQUENTIAL + ("GNN",))
def test_cli_trains_one_epoch_on_the_cpu(root, tmp_path, model):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "dr4sr_tpu_torch.run", "--cpu", "-m", model, "-d", "synthetic",
         "--root", root, "--epochs", "1", "--train-file", "_ori" if model == "CL4SRec2" else "",
         "--set", f"eval.save_path={tmp_path}", "--set", "data.max_seq_len=20"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "'ndcg@20'" in proc.stdout.splitlines()[-1]
    assert os.path.exists(tmp_path / model / "synthetic" / "metrics.jsonl")


def test_context_parallel_is_refused(root):
    cfg = _config("GRU4Rec")
    cfg["model"]["context_parallel"] = 2
    # without a mesh whose model axis is 2 (tests/test_torch_context_parallel.py)
    with pytest.raises(ValueError, match="context_parallel=2 needs a mesh"):
        Trainer(cfg, prepare_datasets(cfg, root=root), device="cpu")


@pytest.mark.parametrize("model", ["NCL", "ICLRec"])
def test_state_is_refreshed_once_an_epoch(root, tmp_path, model, monkeypatch):
    cfg = _config(model, epochs=3)
    trainer = Trainer(cfg, prepare_datasets(cfg, root=root), workdir=str(tmp_path), device="cpu")
    seen = []
    refresh = trainer.model_class.refresh_state

    def counted(tr, nepoch):
        seen.append(nepoch)
        return refresh(tr, nepoch)

    monkeypatch.setattr(trainer.model_class, "refresh_state", staticmethod(counted))
    trainer.fit()
    assert seen == [0, 1, 2]
    key = "proto_centroids" if model == "NCL" else "intent_centroids"
    assert torch.isfinite(trainer.batch_extras[key]).all()


def test_only_the_bilevel_model_is_refused(root):
    """A plain ``Trainer`` refuses DR4SR+'s ``MetaModel`` and names the
    bilevel trainer; ``make_trainer`` gives that trainer for it."""
    from dr4sr_tpu_torch.quickstart import make_trainer
    from dr4sr_tpu_torch.train.meta_trainer import MetaTrainer

    cfg = _config("MetaModel")
    cfg["model"]["sub_model"] = "SASRec"
    cfg["_cli_overrides"] = {"model": {"embed_dim": 32, "hidden_size": 64},
                             "train": {"batch_size": 32}}
    datasets = prepare_datasets(cfg, root=root)
    with pytest.raises(ValueError, match="MetaTrainer"):
        Trainer(cfg, datasets, device="cpu")
    trainer = make_trainer(cfg, datasets, device="cpu")
    assert isinstance(trainer, MetaTrainer) and trainer.config["model"]["model"] == "SASRec"