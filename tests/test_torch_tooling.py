"""The port's tooling modules against the JAX package's, on the CPU:
``utils/parsing.py``, ``utils/tbwriter.py``, ``utils/env.py``, the
prediction metrics and ``get_*_metrics`` of ``evaluation``, and
``Analyzer.plot``. Inputs come from numpy with a fixed seed; metric values
agree within atol 1e-6 (f32), everything else exactly."""

import os
import random
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

from dr4sr_tpu import evaluation as jax_evaluation
from dr4sr_tpu.train.callbacks import Analyzer as JaxAnalyzer
from dr4sr_tpu.utils import env as jax_env
from dr4sr_tpu.utils.parsing import parse_metric_line as jax_parse
from dr4sr_tpu.utils.tbwriter import SummaryWriter as JaxSummaryWriter
from dr4sr_tpu_torch import evaluation
from dr4sr_tpu_torch.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu_torch.train.callbacks import Analyzer
from dr4sr_tpu_torch.utils import env
from dr4sr_tpu_torch.utils.parsing import parse_metric_line
from dr4sr_tpu_torch.utils.tbwriter import SummaryWriter

ATOL = 1e-6

METRIC_LINES = [
    "{'ndcg@20': 0.25, 'recall@20': 0.5}",
    "{'ndcg@20': nan, 'loss': inf, 'b': -inf}",
    "{'name': 'inf', 'information': 1.0, 'x': [nan, 1]}",
    "{'a': (1, 2), 'b': {'c': -nan}}",
    "{'a': __import__('os').getcwd()}",
    "{'a': ().__class__.__base__}",
    "{1, 2}",
    "[1, 2]",
    "not a dict",
    "  {'padded': 3}  ",
    "{",
]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return np.isnan(b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("line", METRIC_LINES)
def test_parse_metric_line_matches_jax(line):
    assert _same(parse_metric_line(line), jax_parse(line))


def test_parse_metric_line_never_evaluates(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    line = "{'a': open('touched', 'w').close()}"
    assert parse_metric_line(line) is None
    assert not os.path.exists("touched")


def test_summary_writer_writes_jax_bytes_that_tensorboard_reads(tmp_path, monkeypatch):
    """The same ``add_scalar`` calls, with the clock and the host fixed,
    give byte-equal files; TensorBoard's own loader reads them back."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    calls = [("train_loss", 1.375, 0), ("ndcg@20", 0.0625, 0), ("train_loss", 1.25, 1),
             ("recall@20", float(np.float32(0.3)), 1), ("big", 3e38, 300)]
    paths = []
    for cls, sub in ((SummaryWriter, "port"), (JaxSummaryWriter, "jax")):
        writer = cls(str(tmp_path / sub))
        for tag, value, step in calls:
            writer.add_scalar(tag, value, step)
        writer.add_scalar("explicit_time", 2.0, 7, walltime=5.5)
        writer.close()
        paths.append(writer._path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    events = list(EventFileLoader(paths[0]).Load())
    assert events[0].file_version == "brain.Event:2"
    # the loader migrates simple_value to a scalar tensor (data_compat)
    got = [(e.summary.value[0].tag, e.summary.value[0].tensor.float_val[0], e.step)
           for e in events[1:]]
    want = [(t, float(np.float32(v)), s) for t, v, s in calls] + [("explicit_time", 2.0, 7)]
    assert got == want
    assert events[-1].wall_time == 5.5


def test_seed_everything_matches_jax(monkeypatch):
    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    draws = []
    for seed_fn in (jax_env.seed_everything, env.seed_everything):
        seed_fn(123)
        draws.append((random.random(), np.random.rand(3).tolist(),
                      os.environ["PYTHONHASHSEED"]))
    assert draws[0] == draws[1]


def test_setup_environment_scopes_debug_nans():
    """``debug_nans`` turns on autograd's anomaly mode with NaN checks for
    the body only: the tests share one process."""
    assert not torch.is_anomaly_enabled()
    with env.setup_environment({"debug_nans": True, "seed": 5}):
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()  # 0/0: the backward finds the NaN
    assert not torch.is_anomaly_enabled()
    with pytest.raises(ZeroDivisionError):
        with env.setup_environment({"debug_nans": True}):
            raise ZeroDivisionError
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("key, value", [("no_compile_cache", True), ("disable_jit", True),
                                        ("debug_nans", False), ("seed", 9)])
def test_setup_environment_accepts_the_other_keys(key, value, monkeypatch):
    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    with env.setup_environment({key: value}):
        seed = value if key == "seed" else 2023
        assert os.environ["PYTHONHASHSEED"] == str(seed)
        assert not torch.is_anomaly_enabled()


def test_setup_environment_refuses_rng_impl():
    with pytest.raises(NotImplementedError, match="rng_impl"):
        with env.setup_environment({"rng_impl": "rbg"}):
            pass


def test_disable_jit_runs_fused_groups_eagerly(tmp_path):
    """``train.disable_jit``: a trainer at N > 1 would capture its groups on
    the card; with the key it runs them eagerly, as on the CPU."""
    from dr4sr_tpu_torch.data.dataset import prepare_datasets
    from dr4sr_tpu_torch.train.trainer import Trainer

    root = str(tmp_path)
    write_synthetic_dataset(root, num_users=40, num_items=20, seed=0)
    captures = []
    for disable in (False, True):
        cfg = synthetic_config()
        cfg["train"].update(steps_per_dispatch=4, disable_jit=disable)
        trainer = Trainer(cfg, prepare_datasets(cfg, root=root), device="cpu")
        trainer.device = torch.device("cuda")  # only the property reads it
        captures.append(trainer._captures)
    assert captures == [True, False]


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("name", ["logloss", "accuracy", "mse", "mae", "auc"])
@pytest.mark.parametrize("ties", [False, True])
def test_prediction_metrics_match_jax(name, ties):
    """Per-sample values (auc: one global value) on the same scores; with
    ``ties`` the scores take 4 distinct values, so ``auc``'s ranks depend on
    its sort keeping tied scores in order."""
    r = np.random.default_rng(3)
    pred = r.normal(size=257).astype(np.float32)
    if ties:
        pred = np.round(pred).clip(-1, 2).astype(np.float32)
    target = (r.random(257) < 0.4).astype(np.float32)
    want = np.asarray(jax_evaluation.metric_dict[name](jnp.asarray(pred), jnp.asarray(target)))
    got = evaluation.metric_dict[name](torch.from_numpy(pred), torch.from_numpy(target))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_auc_keeps_tied_scores_in_order():
    """All scores tied: ranks follow the input order, so the AUC is the
    positives' mean position, not 0.5."""
    pred = torch.zeros(4)
    target = torch.tensor([0.0, 0.0, 1.0, 1.0])
    assert evaluation.auc(pred, target).item() == 1.0
    want = jax_evaluation.auc(jnp.zeros(4), jnp.asarray(target.numpy()))
    assert float(want) == 1.0


@pytest.mark.parametrize("metrics", ["auc", ["ndcg", "auc", "recall", "mse", "bogus"],
                                     ("logloss", "hit", "map")])
def test_metric_name_helpers_match_jax(metrics):
    assert evaluation.get_pred_metrics(metrics) == jax_evaluation.get_pred_metrics(metrics)
    assert evaluation.get_rank_metrics(metrics) == jax_evaluation.get_rank_metrics(metrics)
    for cutoffs in (20, [20, 10], (5, 10, 50)):
        for validation in (False, True):
            assert (evaluation.get_eval_metrics(metrics, cutoffs, validation)
                    == jax_evaluation.get_eval_metrics(metrics, cutoffs, validation))
    assert set(evaluation.metric_dict) == set(jax_evaluation.metric_dict)


def test_rank_metrics_skip_prediction_names():
    pred = torch.zeros(2, 5, dtype=torch.bool)
    out = evaluation.compute_rank_metrics(pred, torch.ones(2), ["ndcg", "auc", "mse"], [5])
    assert list(out) == ["ndcg@5"]


# --------------------------------------------------------------- analyzer


def _recorded(cls):
    r = np.random.default_rng(0)
    analyzer = cls()
    for _ in range(3):
        lens = r.integers(1, 60, size=32)
        analyzer.record_batch(lens, {"ndcg@20": r.random(32), "recall@20": r.random(32)},
                              r.random(32) < 0.9)
    return analyzer


def test_analyzer_plot_writes_a_png(tmp_path):
    port, jax_a = _recorded(Analyzer), _recorded(JaxAnalyzer)
    assert port.summary() == jax_a.summary()
    path = str(tmp_path / "figures" / "epoch_0.png")
    assert port.plot(path) == path
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_analyzer_plot_of_nothing_is_none(tmp_path):
    path = str(tmp_path / "empty.png")
    assert Analyzer().plot(path) is None
    assert JaxAnalyzer().plot(path) is None
    assert not os.path.exists(path)
