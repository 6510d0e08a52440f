"""The port's fused multi-step dispatch (``train.steps_per_dispatch = N > 1``)
on the CPU, where a group's steps run eagerly one after another: the plain
version of the CUDA graph that the card replays.

* ``tests/test_trainer_fused.py``'s and ``tests/test_meta_fused.py``'s
  contracts for the port: N = 4 against N = 1 over 2 epochs equal to the
  bit (parameters, step count, epoch losses), a leftover group of one, the
  whole epoch in one group, ``fit()`` within the JAX test's quality band,
  DR4SR+ at N = 4 (``interval`` 3) and N = 5 (``interval`` 5) equal to its
  per-step run (parameters, meta parameters, the meta optimizer's state,
  outer-step count);
* the same contract for every model of the zoo (dropout 0.1);
* the groups themselves against the JAX package's fused loop: recording
  subclasses of both trainers log each dispatch (a group's size and rows,
  a single step, an outer step) over three epochs, and the logs are equal;
* the pieces: the host stack's dtypes, per-epoch state copied in place,
  optimizer state made before any step, Adam not capturable on the CPU.
"""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.train.meta_trainer import MetaTrainer as JaxMetaTrainer
from dr4sr_tpu.train.trainer import Trainer as JaxTrainer
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu_torch.train.fused import stack_batches, step_batches
from dr4sr_tpu_torch.train.meta_trainer import MetaTrainer
from dr4sr_tpu_torch.train.trainer import Trainer, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "configs")
SMALL = {"embed_dim": 16, "hidden_size": 32, "num_clusters": 4, "num_intent_clusters": 4}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fused_data"))
    write_synthetic_dataset(path, num_users=300, num_items=80, seed=3)
    return path


@pytest.fixture(scope="module")
def meta_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("meta_fused_data"))
    write_synthetic_dataset(path, num_users=200, num_items=60, seed=5)
    return path


def _config(model="SASRec", small=False, **train):
    cfg = synthetic_config(model_name=model,
                           train_file="_ori" if model == "CL4SRec2" else "")
    cfg["train"]["epochs"] = 2
    cfg["model"]["dropout_rate"] = 0.1  # per-step draws in every step
    if small:
        cfg["model"].update(SMALL)
    cfg["train"].update(train)
    return cfg


def _meta_config(**train):
    cfg = synthetic_config()
    cfg["model"].update(model="MetaModel", sub_model="SASRec", tau_min=1.0, dropout_rate=0.1)
    cfg["train"].update(dict(warmup_epoch=0, interval=3, meta_optimizer="sgd",
                             meta_learning_rate=1e-2, hpo_learning_rate=1e-3,
                             meta_weight_decay=0.0), **train)
    cfg["_cli_overrides"] = {"model": {"dropout_rate": 0.1},
                             "train": {"batch_size": 64, **train}}
    return cfg


def _train(cfg, root, epochs):
    trainer = Trainer(copy.deepcopy(cfg), prepare_datasets(cfg, root=root), device="cpu")
    trainer.init_state()
    losses = [trainer.training_epoch(e) for e in range(epochs)]
    return trainer, losses


def _assert_params_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


def test_fused_bitwise_parity(root):
    """N = 4 ≡ N = 1 over 2 epochs: parameters, step count, epoch losses."""
    single, l1 = _train(_config(), root, 2)
    fused, l2 = _train(_config(steps_per_dispatch=4), root, 2)
    assert single.step == fused.step == 2 * len(single.train_data.get_loader())
    _assert_params_equal(single.rec.module, fused.rec.module)
    assert l1 == l2
    assert fused._graphs is None  # no CUDA graph on the CPU


def test_fused_leftover_group(root):
    """N = batches − 1: a group of N, then a leftover group of one."""
    n_batches = len(prepare_datasets(_config(), root=root)[0].get_loader())
    assert n_batches > 2
    fused, l2 = _train(_config(steps_per_dispatch=n_batches - 1), root, 1)
    single, l1 = _train(_config(), root, 1)
    assert single.step == fused.step == n_batches
    _assert_params_equal(single.rec.module, fused.rec.module)
    assert l1 == l2


def test_fused_whole_epoch_one_dispatch(root):
    """N ≥ batches an epoch: the whole epoch in one group."""
    fused, l2 = _train(_config(steps_per_dispatch=10_000), root, 1)
    single, l1 = _train(_config(), root, 1)
    _assert_params_equal(single.rec.module, fused.rec.module)
    assert l1 == l2


def test_fused_fit_end_to_end(root, tmp_path):
    """fit() at N = 8 trains to the JAX test's quality band."""
    cfg = _config(epochs=3, steps_per_dispatch=8)
    trainer = Trainer(cfg, prepare_datasets(cfg, root=root), workdir=str(tmp_path), device="cpu")
    trainer.fit()
    assert trainer.logged_metrics["train_loss"] < 1.4
    assert trainer.logged_metrics["recall@20"] > 0.3


@pytest.mark.parametrize("model,model_cfg", [
    ("FMLP", {}),
    ("GRU4Rec", {}),
    ("CL4SRec", {"augment_type": "item_crop"}),
    ("CL4SRec2", {"augment_type": "item_mask"}),
    ("GNN", {"gnn_layer": 2}),
    ("SGL", {}),
    ("SimGCL", {}),
    ("NCL", {}),
    ("ICLRec", {"augment_type": "item_reorder"}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_fused_parity_across_the_zoo(root, model, model_cfg):
    """Every model of the zoo: N = 3 ≡ N = 1 over 2 epochs, its
    own draws (views, edge masks, noise) and per-epoch state included."""
    runs = []
    for spd in (1, 3):
        cfg = _config(model, small=True, steps_per_dispatch=spd)
        cfg["model"].update(model_cfg)
        runs.append(_train(cfg, root, 2))
    (single, l1), (fused, l2) = runs
    assert single.step == fused.step
    _assert_params_equal(single.rec.module, fused.rec.module)
    assert l1 == l2


def test_refreshed_state_is_copied_in_place(root):
    """NCL's prototypes keep their tensors from one epoch to the next (a
    captured step reads them by address), with the values a fresh refresh
    gives."""
    cfg = _config("NCL", small=True, steps_per_dispatch=3)
    trainer = Trainer(cfg, prepare_datasets(cfg, root=root), device="cpu")
    trainer.init_state()
    trainer.training_epoch(0)
    held = dict(trainer.batch_extras)
    trainer._graphs = "captured"  # as a card's trainer holds its graphs
    fresh = trainer.model_class.refresh_state(trainer, 1)
    trainer.refresh_state(1)
    assert trainer._graphs == "captured"
    for key, value in fresh.items():
        assert trainer.batch_extras[key] is held[key]
        assert torch.equal(trainer.batch_extras[key], value)


def _meta_run(cfg, root, epochs, spd):
    cfg = copy.deepcopy(cfg)
    cfg["_cli_overrides"]["train"]["steps_per_dispatch"] = spd
    trainer = MetaTrainer(cfg, prepare_datasets(cfg, root=root), device="cpu",
                          config_dir=CONFIG_DIR)
    trainer.init_state()
    calls = []
    inner = trainer.outer_step
    trainer.outer_step = lambda *a, **k: calls.append(trainer.step_counter) or inner(*a, **k)
    losses = [trainer.training_epoch(e) for e in range(epochs)]
    return trainer, losses, calls


def _assert_meta_equal(single, fused):
    assert single.step_counter == fused.step_counter and single.step == fused.step
    _assert_params_equal(single.rec.module, fused.rec.module)
    for key, value in single.meta_params.items():
        assert torch.equal(value, fused.meta_params[key]), key
    sa, sb = single.meta_optimizer.state_dict(), fused.meta_optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for key, state in sa["state"].items():
        for name, value in state.items():
            assert torch.equal(torch.as_tensor(value), torch.as_tensor(sb["state"][key][name]))


def test_meta_fused_bitwise_parity(meta_root):
    """DR4SR+ at N = 4 ≡ per-step through warm epoch 0 and weighted epochs
    1–2, with N not dividing ``interval`` 3, so groups stop at its
    boundaries."""
    cfg = _meta_config()
    single, l1, c1 = _meta_run(cfg, meta_root, 3, 1)
    fused, l2, c2 = _meta_run(cfg, meta_root, 3, 4)
    _assert_meta_equal(single, fused)
    assert l1 == l2 and c1 == c2 and c1


def test_meta_fused_interval_boundary_groups(meta_root):
    """N = 5 and ``interval`` 5: the same outer steps, at the same counters,
    and the same meta optimizer state as the per-step run."""
    cfg = _meta_config(interval=5)
    single, _, c1 = _meta_run(cfg, meta_root, 2, 1)
    fused, _, c2 = _meta_run(cfg, meta_root, 2, 5)
    steps = len(single.train_data.get_loader())
    assert c1 == c2 == [c for c in range(5, 2 * steps + 1, 5) if c > steps]
    _assert_meta_equal(single, fused)


# ------------------------------------------------------------- JAX's groups
def _stack(batches, transform):
    hosts = [transform(b, is_train=True) for b in batches]
    return {k: np.stack([h[k] for h in hosts]) for k in hosts[0]}


class _RecordingJax(JaxTrainer):
    """The JAX trainer's epoch loop, every dispatch replaced by a record of
    its host rows."""

    def _device_batch(self, batch, is_train=False):
        return batch

    def _device_batch_stack(self, batches):
        return _stack(batches, self._host_transform)

    @property
    def train_step(self):
        return lambda state, batch, rng: (self.log.append(("step", "train", batch)) or state,
                                          jnp.zeros(()))

    @property
    def multi_train_step(self):
        return lambda state, stack, rngs, extras: (
            self.log.append(("group", "train", stack)) or state, jnp.zeros(len(rngs)))


class _RecordingJaxMeta(JaxMetaTrainer):
    _device_batch = _RecordingJax._device_batch
    _device_batch_stack = _RecordingJax._device_batch_stack
    train_step = _RecordingJax.train_step
    multi_train_step = _RecordingJax.multi_train_step

    @property
    def weighted_train_step(self):
        return lambda state, meta, batch, rng: (
            self.log.append(("step", "weighted", batch)) or state, jnp.zeros(()))

    @property
    def multi_weighted_train_step(self):
        return lambda state, meta, stack, rngs, extras: (
            self.log.append(("group", "weighted", stack)) or state, jnp.zeros(len(rngs)))

    @property
    def outer_step(self):
        return lambda params, meta, opt, vb, tb, rng: (
            self.log.append(("outer", self.step_counter)) or meta, opt)

    @property
    def weight_stats_step(self):
        return lambda params, meta, batch, rng: {}


class _RecordingPort(Trainer):
    def device_batch(self, batch, is_train=False):
        return batch

    def train_step(self, batch):
        self.log.append(("step", "train", batch))
        return torch.zeros(())

    def fused_steps(self, batches, kind, update):
        self.log.append(("group", kind, _stack(batches, self.host_transform)))
        return torch.zeros(len(batches))


class _RecordingPortMeta(MetaTrainer):
    device_batch = _RecordingPort.device_batch
    train_step = _RecordingPort.train_step
    fused_steps = _RecordingPort.fused_steps

    def weighted_train_step(self, batch, **draws):
        self.log.append(("step", "weighted", batch))
        return torch.zeros(())

    def outer_step(self, val_batch, train_batch, **draws):
        self.log.append(("outer", self.step_counter))

    def weight_stats(self, batch, noise=None):
        return {}


def _assert_logs_equal(got, want):
    assert [e[:2] if e[0] != "outer" else e for e in got] == \
        [e[:2] if e[0] != "outer" else e for e in want]
    for g, w in zip(got, want):
        if g[0] == "outer":
            continue
        assert sorted(g[2]) == sorted(w[2])
        for key in g[2]:
            np.testing.assert_array_equal(g[2][key], w[2][key], err_msg=f"{g[:2]} {key}")


@pytest.mark.parametrize("model,spd", [("SASRec", 4), ("SASRec", 10_000), ("FMLP", 16),
                                       ("CL4SRec2", 3)])
def test_groups_match_jax(root, model, spd):
    """The epoch's dispatches over two epochs, N = ``spd``: group sizes,
    leftover single steps and every row of every key, as JAX's fused loop
    makes them (FMLP's pre-padded prefix rows; CL4SRec2's rows of the
    original file beside the regenerated ones)."""
    cfg = _config(model, small=True, steps_per_dispatch=spd)
    cfg["model"]["augment_type"] = "item_crop"
    jax_tr = _RecordingJax(copy.deepcopy(cfg), jax_prepare_datasets(cfg, root=root))
    jax_tr.log, jax_tr._rng = [], jax.random.PRNGKey(0)
    jax_tr.state = types.SimpleNamespace(params=None)
    port = _RecordingPort(copy.deepcopy(cfg), prepare_datasets(cfg, root=root), device="cpu")
    port.init_state()
    port.log = []
    for nepoch in range(2):
        jax_tr.training_epoch(nepoch)
        port.training_epoch(nepoch)
    sizes = [len(e[2]["item_id"]) if e[0] == "group" else 1 for e in port.log]
    assert sum(sizes) == 2 * len(port.train_data.get_loader())
    _assert_logs_equal(port.log, jax_tr.log)


def test_meta_groups_match_jax(meta_root):
    """DR4SR+ at N = 4, ``interval`` 5, warm epoch 0 and weighted epochs 1–2:
    the groups stop at the interval's boundaries, and the outer steps fire
    between them at the same counters, as in JAX's fused loop."""
    cfg = _meta_config(interval=5)
    cfg["_cli_overrides"]["train"]["steps_per_dispatch"] = 4
    cfg["model"]["sub_model"] = "SASRec"
    jax_cfg = copy.deepcopy(cfg)
    jax_tr = _RecordingJaxMeta(jax_cfg, jax_prepare_datasets(jax_cfg, root=meta_root),
                               config_dir=CONFIG_DIR)
    jax_tr.config["train"]["steps_per_dispatch"] = 4
    jax_tr.log, jax_tr._rng = [], jax.random.PRNGKey(0)
    jax_tr.state = types.SimpleNamespace(params=None)
    jax_tr.meta_params = jax_tr.meta_opt_state = None
    port = _RecordingPortMeta(copy.deepcopy(cfg), prepare_datasets(cfg, root=meta_root),
                              device="cpu", config_dir=CONFIG_DIR)
    port.init_state()
    port.log = []
    for nepoch in range(3):
        jax_tr.training_epoch(nepoch)
        port.training_epoch(nepoch)
    assert port.step_counter == jax_tr.step_counter
    assert any(e[0] == "group" and e[1] == "weighted" for e in port.log)
    assert any(e[0] == "outer" for e in port.log)
    _assert_logs_equal(port.log, jax_tr.log)


# ----------------------------------------------------------------- refusals
def test_steps_per_dispatch_below_one_is_refused(root):
    cfg = _config(steps_per_dispatch=0)
    with pytest.raises(ValueError, match="at least 1"):
        Trainer(cfg, prepare_datasets(cfg, root=root), device="cpu")


# ------------------------------------------------------------------- pieces
def test_stack_and_step_batches():
    """int32 widened to int64 as ``device_batch`` widens it; step i reads row
    i of every key and the extras."""
    batches = [{"item_id": np.full((2, 3), i, np.int32), "valid": np.array([True, i > 0])}
               for i in range(3)]
    stacked = stack_batches(batches)
    assert stacked["item_id"].dtype == torch.int64 and stacked["item_id"].shape == (3, 2, 3)
    assert stacked["valid"].dtype == torch.bool
    extra = torch.arange(4)
    steps = step_batches(stacked, {"edge_row": extra}, 3)
    assert [int(s["item_id"][0, 0]) for s in steps] == [0, 1, 2]
    assert all(s["edge_row"] is extra for s in steps)


@pytest.mark.parametrize("name,key", [("rmsprop", "nu"), ("adagrad", "sum_of_squares")])
def test_optax_state_exists_before_the_first_step(name, key):
    """rmsprop's and adagrad's state is made with the optimizer, so that a
    captured step finds it; the first step's update is unchanged."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = make_optimizer([p], {"optimizer": name, "learning_rate": 0.1})
    assert key in opt.state[p]
    p.grad = torch.tensor([0.5, 0.25])
    opt.step()
    if name == "rmsprop":
        want = torch.tensor([1.0, -2.0]) - 0.1 * p.grad / torch.sqrt(0.1 * p.grad ** 2 + 1e-8)
    else:
        want = torch.tensor([1.0, -2.0]) - 0.1 * p.grad / torch.sqrt(0.1 + p.grad ** 2 + 1e-7)
    torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-6)


def test_adam_is_capturable_only_where_graphs_are(root):
    """The CPU trainer at N > 1 keeps the plain Adam (its steps are the
    per-step path's, to the bit); ``capturable`` is the card's."""
    trainer, _ = _train(_config(steps_per_dispatch=4), root, 0)
    assert trainer.optimizer.param_groups[0]["capturable"] is False
    opt = make_optimizer([torch.nn.Parameter(torch.zeros(2))], {}, capturable=True)
    assert opt.param_groups[0]["capturable"] is True


def test_cli_carries_steps_per_dispatch(root, tmp_path, monkeypatch):
    """``--set train.steps_per_dispatch=4`` reaches the trainer, and for
    ``-m MetaModel`` the sub-model's config through ``_cli_overrides``."""
    from dr4sr_tpu_torch import quickstart, run

    made = []
    make = quickstart.make_trainer
    monkeypatch.setattr(quickstart, "make_trainer",
                        lambda *a, **k: made.append(make(*a, **k)) or made[-1])
    common = ["-d", "synthetic", "--root", root, "--cpu", "--epochs", "1",
              "--set", "train.steps_per_dispatch=4", "--set", f"eval.save_path={tmp_path}",
              "--set", "model.embed_dim=16", "--set", "model.hidden_size=32"]
    run.main(["-m", "SASRec", *common])
    run.main(["-m", "MetaModel", *common, "--set", "model.sub_model=SASRec",
              "--set", "train.warmup_epoch=0", "--set", "train.interval=3"])
    plain, meta = made
    assert plain.steps_per_dispatch == meta.steps_per_dispatch == 4
    assert isinstance(meta, MetaTrainer) and meta.config["train"]["steps_per_dispatch"] == 4
    assert meta.step_counter == len(meta.train_data.get_loader())

