"""``quickstart.run``/``tune``, the run and tune CLIs and the trainer's
observability (log file, metrics.jsonl, TensorBoard scalars, the analyzer's
figure, the profiled epoch) of the port, against the JAX package's on the
CPU.

* ``tune`` with the same fake ``run`` patched into both ``quickstart``
  modules: equal ``results`` and ``best`` for grid, random and bayes;
  ``_tpe_propose`` returns the same combo and leaves the same ``Random``
  state.
* ``run(device="cpu")`` and the JAX ``run`` on one tiny synthetic dataset
  (2 epochs, D = 16): the same result keys, log lines, ``metrics.jsonl``
  keys, TensorBoard tags per epoch and ``figures/epoch_0.png``. The metric
  values are not compared: the two packages draw different negatives and
  dropout (their parity is in ``tests/test_torch_train_step.py``).
"""

import copy
import glob
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

from dr4sr_tpu import quickstart as jax_quickstart
from dr4sr_tpu_torch import quickstart
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu_torch.utils.parsing import parse_metric_line
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 2


def _fake_run(cfg, root=None, **kwargs):
    """A deterministic stand-in for ``run``: ties between learning rates at
    equal embed_dim, so the selection's tie rule shows too."""
    lr, d = cfg["train"]["learning_rate"], cfg["model"]["embed_dim"]
    return {"val_best": (1.0 if d == 64 else 0.1 * (d % 3)) + (lr if d != 32 else 0.0),
            "ndcg@20": lr * d}


SWEEP = {"train.learning_rate": [1e-4, 1e-3, 1e-2], "model.embed_dim": [16, 32, 48, 64]}


@pytest.mark.parametrize("method, samples, seed", [
    ("grid", None, 0), ("random", 5, 0), ("random", 7, 1), ("random", None, 2),
    ("bayes", 9, 0), ("bayes", 9, 1), ("bayes", 6, 2), ("bayes", 2, 5)])
def test_tune_matches_jax(monkeypatch, method, samples, seed):
    monkeypatch.setattr(jax_quickstart, "run", _fake_run)
    monkeypatch.setattr(quickstart, "run", _fake_run)
    cfg = {"train": {"learning_rate": 0}, "model": {"embed_dim": 0}}
    got = quickstart.tune(copy.deepcopy(cfg), SWEEP, method=method, samples=samples, seed=seed,
                          device="cpu")
    want = jax_quickstart.tune(copy.deepcopy(cfg), SWEEP, method=method, samples=samples,
                               seed=seed)
    assert got == want
    best, results = got
    assert best["metrics"]["val_best"] == max(r["metrics"]["val_best"] for r in results)


def test_tune_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="unknown sweep method"):
        quickstart.tune({}, SWEEP, method="hyperband")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tpe_propose_matches_jax(seed):
    keys = sorted(SWEEP)
    r = np.random.default_rng(seed)
    observed = [((float(r.choice(SWEEP[keys[0]])), int(r.choice(SWEEP[keys[1]]))),
                 float(r.random())) for _ in range(3 + seed)]
    ours, theirs = random.Random(seed), random.Random(seed)
    got = quickstart._tpe_propose(keys, SWEEP, observed, ours)
    assert got == jax_quickstart._tpe_propose(keys, SWEEP, observed, theirs)
    assert ours.getstate() == theirs.getstate()


# ------------------------------------------------------- the run, both packages


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("quickstart_data"))
    write_synthetic_dataset(path, num_users=120, num_items=40, seed=2)
    return path


def _config(base, **train):
    cfg = synthetic_config()
    cfg["model"].update(embed_dim=16, hidden_size=32)
    cfg["train"].update(epochs=EPOCHS, tensorboard_dir=os.path.join(base, "tb"), **train)
    cfg["eval"]["save_path"] = os.path.join(base, "saved")
    return cfg


def _in_dir(path, fn):
    """``fn()`` with ``path`` as the working directory (the log goes there)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(path)
        return fn()


@pytest.fixture(scope="module")
def port_run(root, tmp_path_factory):
    base = str(tmp_path_factory.mktemp("port_run"))
    cfg = _config(base, profile_epoch=1, profile_dir=os.path.join(base, "profile"))
    out = _in_dir(base, lambda: quickstart.run(cfg, root=root, device="cpu"))
    return base, out


@pytest.fixture(scope="module")
def jax_run(root, tmp_path_factory):
    base = str(tmp_path_factory.mktemp("jax_run"))
    cfg = _config(base, no_compile_cache=True)
    out = _in_dir(base, lambda: jax_quickstart.run(cfg, root=root))
    return base, out


def test_run_returns_the_jax_keys(port_run, jax_run):
    assert sorted(port_run[1]) == sorted(jax_run[1])
    assert all(np.isfinite(v) for v in port_run[1].values())
    assert port_run[1]["val_best"] > 0


def _log_lines(base):
    (path,) = glob.glob(os.path.join(base, "log", "SASRec", "synthetic", "*.log"))
    with open(path) as f:
        return f.read().splitlines()


def test_run_writes_the_log_file(port_run, jax_run):
    for base in (port_run[0], jax_run[0]):
        text = "\n".join(_log_lines(base))
        for want in ("INFO config: {", "INFO dataset synthetic: ", "INFO epoch 0: ",
                     "INFO epoch 1: "):
            assert want in text, (base, want)
    port = _log_lines(port_run[0])
    assert sum("INFO test: {" in line for line in port) == 1
    assert sum("INFO epoch 0: " in line for line in port) == 1


def _jsonl(base):
    with open(os.path.join(base, "saved", "SASRec", "synthetic", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_metrics_jsonl_has_the_jax_keys(port_run, jax_run):
    port, jax_ = _jsonl(port_run[0]), _jsonl(jax_run[0])
    assert [r["epoch"] for r in port] == list(range(EPOCHS))
    assert [sorted(r) for r in port] == [sorted(r) for r in jax_]


def _scalars(base):
    """{(step, tag): value} of the run's event file."""
    (path,) = glob.glob(os.path.join(base, "tb", "events.out.tfevents.*"))
    out = {}
    for event in list(EventFileLoader(path).Load())[1:]:
        for v in event.summary.value:
            out[(event.step, v.tag)] = v.tensor.float_val[0]
    return out


def test_tensorboard_has_the_jax_tags_and_the_jsonl_values(port_run, jax_run):
    port, jax_ = _scalars(port_run[0]), _scalars(jax_run[0])
    assert sorted(port) == sorted(jax_)
    want = {(r["epoch"], k): float(np.float32(v)) for r in _jsonl(port_run[0])
            for k, v in r.items() if isinstance(v, float)}
    assert port == want


def test_the_analyzer_figure_of_epoch_0(port_run, jax_run):
    for base in (port_run[0], jax_run[0]):
        figures = os.listdir(os.path.join(base, "saved", "SASRec", "synthetic", "figures"))
        assert figures == ["epoch_0.png"]


def test_the_profiled_epoch_holds_its_training_ops(port_run):
    """One trace (rank 0) of epoch 1's training: the step's CPU ops and
    Adam's update, and none of the evaluation's top-k."""
    (path,) = glob.glob(os.path.join(port_run[0], "profile", "rank0.*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") in ("cpu_op", "user_annotation")}
    assert "aten::embedding" in names and names & {"aten::mm", "aten::addmm"}
    assert any(n.startswith("Optimizer.step#Adam") for n in names)
    assert "aten::topk" not in names


def test_run_defaults_to_the_card(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    cfg = _config(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _in_dir(str(tmp_path), lambda: quickstart.run(cfg, root=root))


def test_meta_trainer_takes_tensorboard_dir(root, tmp_path):
    """DR4SR+ inherits the observability hooks (the sub-model's train
    section holds the keys, as under the JAX ``MetaTrainer``)."""
    cfg = synthetic_config()
    cfg["model"].update(model="MetaModel", sub_model="SASRec")
    tb = str(tmp_path / "tb")
    cfg["train"].update(warmup_epoch=0, interval=2, epochs=1)
    cfg["eval"]["save_path"] = str(tmp_path / "saved")
    cfg["_cli_overrides"] = {"model": {"embed_dim": 16, "hidden_size": 32},
                             "train": {"tensorboard_dir": tb, "epochs": 1,
                                       "profile_epoch": 0,
                                       "profile_dir": str(tmp_path / "profile")},
                             "eval": {"save_path": str(tmp_path / "saved")}}
    trainer = quickstart.make_trainer(cfg, prepare_datasets(cfg, root=root), device="cpu")
    trainer.fit()
    assert trainer.step_counter > 0
    tags = {v.tag for path in glob.glob(os.path.join(tb, "events.*"))
            for e in EventFileLoader(path).Load() for v in e.summary.value}
    assert {"train_loss", "ndcg@20", "recall@20"} <= tags
    assert len(glob.glob(str(tmp_path / "profile" / "rank0.*.pt.trace.json"))) == 1


# ---------------------------------------------------------------- the CLIs


def _cli(args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-m", *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=600)


def test_run_cli_logs_each_line_once(root, tmp_path):
    proc = _cli(["dr4sr_tpu_torch.run", "--cpu", "-m", "SASRec", "-d", "synthetic", "--root",
                 root, "--epochs", "1", "--set", f"eval.save_path={tmp_path / 'saved'}",
                 "--set", "model.embed_dim=16", "--set", "model.hidden_size=32",
                 "--set", f"train.tensorboard_dir={tmp_path / 'tb'}"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("epoch 0: ") == 1  # basicConfig's handler alone prints it
    out = parse_metric_line(proc.stdout.strip().splitlines()[-1])
    assert out is not None and "val_best" in out and "recall@20" in out
    assert any("epoch 0: " in line for line in _log_lines(str(tmp_path)))
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))


def test_tune_cli_runs_a_grid(root, tmp_path):
    sweep = tmp_path / "sweep.yaml"
    sweep.write_text(
        "train.learning_rate: [0.001, 0.003]\n"
        "train.epochs: [1]\n"
        "model.embed_dim: [16]\n"
        "model.hidden_size: [32]\n"
        f"eval.save_path: ['{tmp_path / 'saved'}']\n"
        "method: random\n"
        "metric: {name: ndcg@20}\n")
    proc = _cli(["dr4sr_tpu_torch.tune", "--cpu", "-m", "SASRec", "-d", "synthetic",
                 "--root", root, "--sweep", str(sweep), "--method", "grid"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout[proc.stdout.index("{\n"):])
    assert [r["params"]["train.learning_rate"] for r in out["all"]] == [0.001, 0.003]
    assert out["best"]["metrics"]["val_best"] == max(r["metrics"]["val_best"] for r in out["all"])
    assert len(glob.glob(str(tmp_path / "log" / "SASRec" / "synthetic" / "*.log"))) == 2
