"""The port's bilevel trainer (``train.meta_trainer.MetaTrainer``) against
the JAX package's, on the CPU, at a small size (D 16, 2 layers, 2 heads,
L 10, batch 8; dropout 0 unless a test says otherwise). The draws are
JAX's, reproduced from its key splits and fed in: in ``_weighted_loss``
``rng_loss, rng_gumbel = split(rng)`` (a contrastive sub-model then splits
``rng_cl`` off ``rng_loss``), the negatives from ``split(rng_loss)[0]``; in
``outer_step`` ``r_val, r_train = split(rng)``.

* ``_weighted_loss`` and its gradients for SASRec, GRU4Rec, FMLP and
  CL4SRec under ``inner_loss_scale`` sum and mean, on a padded last batch
  with pattern rows: atol 1e-5 (f32, as the zoo's parity tests);
* one outer step from JAX's weights: the hypergradient (each meta
  parameter's error over its largest element ≤ 1e-5: second derivatives in
  f32, summed in other orders) and the meta parameters after it, SGD with
  momentum and weight decay or Adam (atol 1e-6);
* the schedule of warm, weighted and outer steps and of the probe over
  three epochs, and the rows each reads, equal to the JAX trainer's;
* the CLI, the overrides reaching the sub-model's config, the refusals,
  inner steps leaving the meta parameters alone, the outer step on the
  plain attention route, and its repeatability under dropout.
"""

import copy
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_meta_parity import (
    CONFIG_DIR,
    assert_close_to_largest,
    jax_meta_as_port,
    t,
    weighted_draws,
)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
from torch_zoo_parity import assert_grads_match

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.synthetic import synthetic_config as jax_synthetic_config
from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu.meta.hypergrad import hypergradient as jax_hypergradient
from dr4sr_tpu.models.base import sample_negatives as jax_sample_negatives
from dr4sr_tpu.ops.attention import reference_attention
from dr4sr_tpu.train.meta_trainer import MetaTrainer as JaxMetaTrainer
from dr4sr_tpu_torch import quickstart, run
from dr4sr_tpu_torch.convert import meta_params_from_jax, params_from_jax
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.ops import attention
from dr4sr_tpu_torch.train.meta_trainer import MetaTrainer
from dr4sr_tpu_torch.train.trainer import Trainer

NUM_ITEMS, L, BATCH = 40, 10, 8
ATOL = 1e-5
HYPER_RTOL = 1e-5
META_ATOL = 1e-6
SMALL = {"embed_dim": 16, "hidden_size": 32, "head_num": 2, "layer_num": 2,
         "dropout_rate": 0.0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("meta_trainer"))
    jax_write(path, num_users=60, num_items=NUM_ITEMS, max_seq_len=L, seed=3)
    return path


def _config(sub_model, model=None, **train):
    cfg = jax_synthetic_config(max_seq_len=L)
    cfg["model"].update(model="MetaModel", sub_model=sub_model, tau_min=1.0)
    cfg["train"].update(dict(batch_size=BATCH, warmup_epoch=0, interval=3,
                             meta_optimizer="sgd", meta_learning_rate=1e-2,
                             hpo_learning_rate=1e-3, meta_weight_decay=1e-3), **train)
    cfg["_cli_overrides"] = {"model": {**SMALL, **(model or {})},
                             "train": {"batch_size": BATCH}}
    return cfg


def _pair(cfg, root):
    """The JAX trainer and the port's (CPU), from the same weights: JAX's,
    carried over (the meta MLP and τ too)."""
    jax_tr = JaxMetaTrainer(copy.deepcopy(cfg), jax_prepare_datasets(cfg, root=root),
                            config_dir=CONFIG_DIR)
    jax_tr.init_state(seed=0)
    tr = MetaTrainer(copy.deepcopy(cfg), prepare_datasets(cfg, root=root), device="cpu",
                     config_dir=CONFIG_DIR)
    tr.init_state(seed=0)
    params = jax.tree_util.tree_map(np.asarray, jax_tr.state.params)
    tr.rec.module.load_state_dict(params_from_jax(params, tr.rec.module))
    tr.load_meta(*meta_params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tr.meta_params),
                                       tr.meta_module))
    return jax_tr, tr


def _last_batch_with_patterns(trainer):
    """The padded last batch of epoch 1, its first two rows made pattern rows."""
    batch = list(trainer.train_data.get_loader(seed=1))[-1]
    assert not batch["valid"].all()
    batch["user_id"] = batch["user_id"].copy()
    batch["user_id"][:2] = 0
    return batch


@pytest.mark.parametrize("scale", ["sum", "mean"])
@pytest.mark.parametrize("sub_model", ["SASRec", "GRU4Rec", "FMLP", "CL4SRec"])
def test_weighted_loss_and_gradients_match_jax(root, sub_model, scale):
    jax_tr, tr = _pair(_config(sub_model, inner_loss_scale=scale), root)
    batch = _last_batch_with_patterns(tr)
    jbatch = jax_tr._device_batch(batch, is_train=True)
    key = jax.random.PRNGKey(5)
    want, want_grads = jax.value_and_grad(
        lambda p: jax_tr._weighted_loss(p, jax_tr.meta_params, jbatch, key))(jax_tr.state.params)
    neg, views, noise = weighted_draws(jax_tr, jbatch, key)
    meta = {k: v.detach() for k, v in tr.meta_params.items()}
    got = tr._weighted_loss(tr.device_batch(batch, is_train=True), meta, neg_id=neg,
                            views=views, noise=noise)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    assert_grads_match(tr.rec.module, jax.tree_util.tree_map(np.asarray, want_grads), ATOL)


def test_pattern_rows_reproduce_the_unweighted_summed_loss(root):
    """tests/test_meta.py's mask check on the port: a batch of pattern rows
    (weight 1, padding 0) gives Σ of the per-position losses."""
    _, tr = _pair(_config("SASRec"), root)
    batch = tr.device_batch(tr.train_data.get_loader(seed=0).sample_batch(BATCH), is_train=True)
    batch["user_id"] = torch.zeros_like(batch["user_id"])
    neg = torch.randint(1, NUM_ITEMS, (BATCH, L, 1), generator=torch.Generator().manual_seed(0))
    w_loss = tr._weighted_loss(batch, tr.meta_params, neg_id=neg)
    ref = tr.rec.training_loss(batch, None, neg_id=neg, reduce=False)
    torch.testing.assert_close(w_loss, ref.sum(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("sub_model,optimizer", [("SASRec", "sgd"), ("SASRec", "adam"),
                                                 ("GRU4Rec", "sgd"), ("FMLP", "sgd")])
def test_outer_step_matches_jax(root, sub_model, optimizer):
    """One outer step from JAX's weights and the same val-proxy and train
    batches: the hypergradient, and the meta parameters after the clip and
    the meta optimizer's step."""
    jax_tr, tr = _pair(_config(sub_model, meta_optimizer=optimizer), root)
    loader = tr.train_data.get_loader(seed=4099)
    vb, tb = loader.sample_batch(), loader.sample_batch()
    jval, jtrain = (jax_tr._device_batch(b, is_train=True) for b in (vb, tb))
    key = jax.random.PRNGKey(9)
    r_val, r_train = jax.random.split(key)
    with reference_attention():
        want_h = jax_hypergradient(
            lambda p, m: jax_tr._weighted_loss(p, m, jtrain, r_train),
            lambda p: jax_tr.rec.training_loss({"params": p}, jval, r_val),
            jax_tr.state.params, jax_tr.meta_params, lr=jax_tr.hpo_lr, truncate_iter=3)
    want_h = jax_meta_as_port(want_h, tr.meta_module)
    want_meta, _ = jax_tr.outer_step(jax_tr.state.params, jax_tr.meta_params,
                                     jax_tr.meta_opt_state, jval, jtrain, key)
    want_meta = jax_meta_as_port(want_meta, tr.meta_module)

    neg, _, noise = weighted_draws(jax_tr, jtrain, r_train)
    val_neg = jax_sample_negatives(jax.random.split(r_val)[0], jval, NUM_ITEMS, L)
    before = {k: v.detach().clone() for k, v in tr.meta_params.items()}
    got_h = tr.outer_step(tr.device_batch(vb, is_train=True), tr.device_batch(tb, is_train=True),
                          val_neg=t(val_neg).long(), train_neg=neg, noise=noise)
    assert_close_to_largest(got_h, want_h, HYPER_RTOL, "hypergradient")
    for k, w in want_meta.items():
        np.testing.assert_allclose(tr.meta_params[k].detach().numpy(), w.numpy(), atol=META_ATOL,
                                   rtol=0, err_msg=k)
    assert any((tr.meta_params[k].detach() != before[k]).any() for k in before)
    assert all(p.grad is None for p in tr.rec.module.parameters())


class _RecordingJax(JaxMetaTrainer):
    """The JAX trainer's epoch loop with every step replaced by a record of
    its host batches."""

    def _device_batch(self, batch, is_train=False):
        return batch

    @property
    def train_step(self):
        return lambda state, batch, rng: (self.log.append(("warm", batch)) or state, jnp.zeros(()))

    @property
    def weighted_train_step(self):
        return lambda state, meta, batch, rng: (self.log.append(("weighted", batch)) or state,
                                                jnp.zeros(()))

    @property
    def outer_step(self):
        return lambda params, meta, opt, vb, tb, rng: (self.log.append(("outer", vb, tb)) or meta,
                                                       opt)

    @property
    def weight_stats_step(self):
        return lambda params, meta, batch, rng: self.log.append(("probe", batch)) or {}


class _RecordingPort(MetaTrainer):
    def device_batch(self, batch, is_train=False):
        return batch

    def train_step(self, batch):
        self.log.append(("warm", batch))
        return torch.zeros(())

    def weighted_train_step(self, batch, **draws):
        self.log.append(("weighted", batch))
        return torch.zeros(())

    def outer_step(self, val_batch, train_batch, **draws):
        self.log.append(("outer", val_batch, train_batch))

    def weight_stats(self, batch, noise=None):
        self.log.append(("probe", batch))
        return {}


def test_schedule_over_three_epochs_matches_jax(root):
    """Warm epoch 0, weighted epochs 1 and 2, an outer step whenever the
    step counter (across epochs) is a multiple of ``interval``, a probe at
    the end of each weighted epoch: the same steps in the same order as the
    JAX trainer's, each reading the same rows."""
    cfg = _config("SASRec", interval=5)
    jax_tr = _RecordingJax(copy.deepcopy(cfg), jax_prepare_datasets(cfg, root=root),
                           config_dir=CONFIG_DIR)
    jax_tr.log, jax_tr._rng = [], jax.random.PRNGKey(0)
    jax_tr.state = types.SimpleNamespace(params=None)
    jax_tr.meta_params = jax_tr.meta_opt_state = None
    tr = _RecordingPort(copy.deepcopy(cfg), prepare_datasets(cfg, root=root), device="cpu",
                        config_dir=CONFIG_DIR)
    tr.init_state()
    tr.log = []
    for nepoch in range(3):
        jax_tr.training_epoch(nepoch)
        tr.training_epoch(nepoch)
    steps = len(tr.train_data.get_loader())
    kinds = [e[0] for e in tr.log]
    assert kinds == [e[0] for e in jax_tr.log]
    assert kinds.count("warm") == steps and kinds.count("weighted") == 2 * steps
    assert kinds.count("outer") == (3 * steps) // 5 - steps // 5 and kinds.count("probe") == 2
    assert tr.step_counter == jax_tr.step_counter == 3 * steps
    # an outer step follows the step that brings the counter to a multiple of 5
    counter = 0
    for i, kind in enumerate(kinds):
        if kind in ("warm", "weighted"):
            counter += 1
            fires = kind == "weighted" and counter % 5 == 0
            assert (i + 1 < len(kinds) and kinds[i + 1] == "outer") == fires
    for got, want in zip(tr.log, jax_tr.log):
        for g, w in zip(got[1:], want[1:]):
            assert sorted(g) == sorted(w)
            for key in g:
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{got[0]} {key}")


def test_cli_trains_the_bilevel_model(root, tmp_path, monkeypatch):
    """``run.main -m MetaModel --cpu``: configs/metamodel.yaml with
    ``--set model.sub_model=SASRec``; the overrides reach the sub-model."""
    made = []
    make = quickstart.make_trainer
    monkeypatch.setattr(quickstart, "make_trainer", lambda *a, **k: made.append(make(*a, **k))
                        or made[-1])
    out = run.main(["-m", "MetaModel", "-d", "synthetic", "--root", root, "--cpu",
                    "--epochs", "2", "--set", "model.sub_model=SASRec",
                    "--set", "model.embed_dim=16", "--set", "model.hidden_size=32",
                    "--set", f"data.max_seq_len={L}", "--set", f"train.batch_size={BATCH}",
                    "--set", "train.warmup_epoch=0", "--set", "train.interval=4",
                    "--set", "train.seed=7", "--set", f"eval.save_path={tmp_path}"])
    (trainer,) = made
    assert isinstance(trainer, MetaTrainer) and trainer.device.type == "cpu"
    assert trainer.config["model"]["model"] == "SASRec"
    assert trainer.config["train"]["seed"] == 7 and trainer.config["train"]["epochs"] == 2
    assert trainer.config["model"]["embed_dim"] == 16
    assert trainer.step_counter == 2 * len(trainer.train_data.get_loader())
    assert all(np.isfinite(v) for v in out.values())
    with open(os.path.join(tmp_path, "MetaModel", "synthetic", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 2 and "weight_mean" not in records[0]  # epoch 0 is warm
    assert np.isfinite([records[1][k] for k in ("weight_mean", "weight_std", "tau",
                                                "train_loss")]).all()


def test_cli_overrides_reach_the_sub_model_config(root):
    """tests/test_meta.py's case: ``_cli_overrides`` re-applied to the
    freshly loaded sub-model config; its YAML keeps what was not overridden."""
    cfg = _config("SASRec")
    cfg["_cli_overrides"] = {"train": {"seed": 7, "epochs": 5}}
    tr = MetaTrainer(cfg, prepare_datasets(cfg, root=root), device="cpu", config_dir=CONFIG_DIR)
    assert tr.config["train"]["seed"] == 7 and tr.config["train"]["epochs"] == 5
    assert tr.config["train"]["learning_rate"] == 0.001
    assert tr.config["data"]["max_seq_len"] == L  # the MetaModel config's data section
    assert tr.model_name == "MetaModel"


@pytest.mark.parametrize("override,error,match", [
    ({"model": {"context_parallel": 2}}, ValueError, "context_parallel"),
    # its aux_loss reads refresh_state's prototypes, which the bilevel epoch
    # never fits (the JAX package fails there: tests/test_torch_meta_aux.py)
    ({"model": {"sub_model": "NCL"}}, NotImplementedError, "aux_loss"),
])
def test_refusals(root, override, error, match):
    cfg = _config("SASRec")
    override = copy.deepcopy(override)
    sub_model = override.get("model", {}).pop("sub_model", None)
    if sub_model is not None:
        cfg["model"]["sub_model"] = sub_model
    for section, kv in override.items():
        cfg["_cli_overrides"].setdefault(section, {}).update(kv)
    with pytest.raises(error, match=match):
        MetaTrainer(cfg, prepare_datasets(cfg, root=root), device="cpu", config_dir=CONFIG_DIR)


def test_inner_steps_leave_the_meta_parameters_alone(root):
    """Weighted steps move the sub-model only: the meta MLP and τ gather no
    ``.grad`` and keep their values. The weighted steps take the kernel's
    route (outside ``plain_attention``), the outer step the plain route."""
    cfg = _config("SASRec", model={"dropout_rate": 0.5})
    tr = MetaTrainer(cfg, prepare_datasets(cfg, root=root), device="cpu", config_dir=CONFIG_DIR)
    tr.init_state()
    meta = {k: v.detach().clone() for k, v in tr.meta_params.items()}
    sub = {k: v.detach().clone() for k, v in tr.rec.module.named_parameters()}
    routes = []
    plain = attention.mha_reference

    def recording(*args, **kwargs):
        routes.append(attention._PLAIN.get())
        return plain(*args, **kwargs)

    attention.mha_reference = recording
    try:
        for batch, _ in zip(tr.train_data.get_loader(seed=0), range(4)):
            loss = tr.weighted_train_step(tr.device_batch(batch, is_train=True))
            assert torch.isfinite(loss)
        inner_routes, routes[:] = list(routes), []
        loader = tr.train_data.get_loader(seed=1)
        tr.outer_step(*(tr.device_batch(loader.sample_batch(), is_train=True) for _ in range(2)))
    finally:
        attention.mha_reference = plain
    assert inner_routes and not any(inner_routes)
    assert routes and all(routes)  # the val and train forwards, 2 layers each
    assert len(routes) == 4
    for k, v in tr.rec.module.named_parameters():
        assert not torch.equal(v.detach(), sub[k]), k
    assert all(p.grad is None for p in tr.meta_params.values())
    assert any(not torch.equal(tr.meta_params[k].detach(), meta[k]) for k in meta)


def test_outer_step_repeats_under_dropout(root):
    """With dropout 0.5, two outer steps from the same weights, meta state
    and generator states give the same meta parameters: one forward of the
    train loss serves every Hessian-vector product."""
    cfg = _config("SASRec", model={"dropout_rate": 0.5})
    tr = MetaTrainer(cfg, prepare_datasets(cfg, root=root), device="cpu", config_dir=CONFIG_DIR)
    tr.init_state()
    loader = tr.train_data.get_loader(seed=2)
    vb, tb = (tr.device_batch(loader.sample_batch(), is_train=True) for _ in range(2))
    meta0 = {k: v.detach().clone() for k, v in tr.meta_params.items()}
    gen, cpu_rng = tr.generator.get_state(), torch.get_rng_state()
    results = []
    for _ in range(2):
        tr.load_meta({k: v for k, v in meta0.items() if k != "tau"}, meta0["tau"].item())
        tr.meta_optimizer = tr._make_meta_optimizer()
        tr.generator.set_state(gen)
        torch.set_rng_state(cpu_rng)
        tr.outer_step(vb, tb)
        results.append({k: v.detach().clone() for k, v in tr.meta_params.items()})
    for k in meta0:
        torch.testing.assert_close(results[0][k], results[1][k], rtol=0, atol=0)
    assert any(not torch.equal(results[0][k], meta0[k]) for k in meta0)


def test_make_trainer_picks_the_trainer(root):
    cfg = _config("SASRec")
    datasets = prepare_datasets(cfg, root=root)
    assert isinstance(quickstart.make_trainer(cfg, datasets, device="cpu"), MetaTrainer)
    plain = copy.deepcopy(cfg)
    plain["model"] = {**plain["model"], **SMALL, "model": "SASRec"}
    got = quickstart.make_trainer(plain, prepare_datasets(plain, root=root), device="cpu")
    assert type(got) is Trainer
