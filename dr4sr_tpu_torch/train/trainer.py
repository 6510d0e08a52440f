"""The training and evaluation engine.

Port of ``dr4sr_tpu/train/trainer.py`` for one device: a host-side epoch
loop around

* a train step — forward in train mode, negatives drawn on the device from
  an explicit ``torch.Generator``, BCE/BPR loss (plus, for CL4SRec and
  CL4SRec2, ``cl_weight`` × the InfoNCE of two augmented views, and a
  model's ``aux_loss``, their draws from the same generator), backward
  (attention through the CUDA backward kernel on the card), optimizer
  update;
* an eval step — encode in eval mode, full-catalog masked top-k, per-sample
  rank metrics summed on the device; the host only divides at the end.

``train.precision: bf16`` runs forward and backward under
``torch.autocast(device, bfloat16)`` with f32 master weights; eval stays
f32. Seeds as in the JAX trainer: the weights from ``train.seed``, the
step's draws (negatives, dropout) from ``train.seed + 1``.

Model-class flags and hooks, as the JAX trainer reads them:
``contrastive`` adds the contrastive term; ``aug_from_original`` (CL4SRec2)
takes the views' rows from a second loader over the original train file;
``prefix_training`` (FMLP) expands the train rows to per-prefix rows at
construction, and ``pre_padding`` moves the padding of every other batch to
the front; ``needs_graph`` (GNN, SGL, SimGCL, NCL) builds the item-transition
graph once on the host and moves it to the device once; its edges ride in
``batch_extras``, merged into every device batch, train and eval;
``aux_loss`` (with ``aux_draws``, its random draws) adds a model's term to
the loss; ``refresh_state`` refits per-epoch state (NCL's prototypes,
ICLRec's intents) into ``batch_extras`` at the start of every epoch
(:meth:`Trainer.refresh_state`).

``train.steps_per_dispatch = N > 1`` takes an epoch's batches in groups of
N, as the JAX trainer's fused loop does: a group of N runs as one dispatch
(``train.fused``: on the card one replay of a CUDA graph of the N steps,
with Adam ``capturable``; on the CPU the same steps one after another), a
leftover group of 1 as a plain step. A model whose step cannot be captured
is refused up front (``fused.capture_refusal``).

DR4SR+ (``MetaModel``, ``is_meta``) trains under the subclass
``train.meta_trainer.MetaTrainer``, which ``quickstart.make_trainer`` picks;
a plain ``Trainer`` refuses it. ``train.disable_jit`` runs the groups
eagerly (the same steps, no graph); ``train.rng_impl`` (JAX's PRNG choice)
is refused.

Observability, as the JAX trainer's: every epoch's metrics go to
``<save base>/<model>/<dataset>/metrics.jsonl`` and, with
``train.tensorboard_dir``, each float of them to a TensorBoard event file
there (``utils/tbwriter.py``; step = epoch); ``train.profile_epoch = n``
wraps epoch n's training (not its eval) in ``torch.profiler`` (CPU, and
CUDA on the card) and writes one trace a rank into ``train.profile_dir``;
every 10 epochs the analyzer's figure goes to ``figures/epoch_<n>.png``
beside ``metrics.jsonl``. Process 0 alone writes the metrics, events and
figures.

Several devices (``mesh_plan``, a ``parallel.mesh.MeshPlan``; one process a
rank), as the JAX trainer places them (its ``:67-72``, ``:118-144``,
``:188-216``, ``:237-261``, ``:362-407``):

* every rank builds the same global host batch, pads it to a multiple of
  the ``data`` axis (``valid=False``) and keeps its rows; negatives are
  drawn for the global batch from generators in lockstep; the loss divides
  by the global count; after the backward the gradients (and the loss) are
  summed over the ``data`` group in one all-reduce, so at dropout 0 W ranks
  take the steps one process takes. Dropout draws from each rank's default
  generator, seeded ``seed + 1 + 7919 · data index``: the ranks of one
  ``model`` group draw the same masks (they compute the same rows), and the
  ``data`` ranks draw apart;
* ``shard_embedding`` row-shards the item table over ``model``
  (``parallel/ep.py``): each rank holds N/S rows of the padded table, and
  eval takes ``ops.topk.sharded_masked_topk``; every other parameter is
  replicated and broadcast from rank 0;
* ``model.context_parallel = n`` (n the ``model`` axis size) routes encoder
  attention through the ring (``ops/ring_attention.py``);
* eval: per-sample metric sums and the count are summed over ``data``
  before the host divides, so early stopping decides on the same value on
  every rank; process 0 alone writes checkpoints, state and logs, with the
  table gathered (and saved padded, as the JAX trainer's ``device_get``
  saves it).

At world size > 1 these are refused with a ``NotImplementedError`` that
says why: ``train.steps_per_dispatch > 1``, a model with ``contrastive`` or
``aux_loss``, GNN under EP, and DR4SR+ (``MetaTrainer``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import json
import logging
import os
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dr4sr_tpu_torch import evaluation
from dr4sr_tpu_torch.data.dataset import SeqDataset
from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.models.base import RecModel, item_table
from dr4sr_tpu_torch.models.cl4srec import cl_loss
from dr4sr_tpu_torch.models.fmlp import expand_prefix_rows, pre_pad_batch
from dr4sr_tpu_torch.models.gnn import build_transition_graph
from dr4sr_tpu_torch.ops import ring_attention
from dr4sr_tpu_torch.ops.topk import sharded_masked_topk
from dr4sr_tpu_torch.parallel import ep
from dr4sr_tpu_torch.parallel.collectives import all_gather, all_reduce_, gather_objects
from dr4sr_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    MeshPlan,
    pad_batch_to_multiple,
    process_index,
    replicate,
    shard_batch,
)
from dr4sr_tpu_torch.train.callbacks import Analyzer, EarlyStopping
from dr4sr_tpu_torch.train.checkpoint import load_checkpoint
from dr4sr_tpu_torch.train.fused import StepGraphs, capture_refusal, stack_batches, step_batches
from dr4sr_tpu_torch.utils.env import refuse_rng_impl
from dr4sr_tpu_torch.utils.tbwriter import SummaryWriter

logger = logging.getLogger("dr4sr_tpu_torch")

# CL4SRec2's views read the original train file with this seed offset
_ORIGINAL_LOADER_SEED = 7919
# the dropout stream of data rank d is seeded seed + 1 + d * this
_DROPOUT_RANK_STRIDE = 7919
_TABLE = "item_embedding.weight"


class _OptaxRMS(torch.optim.Optimizer):
    """optax ``scale_by_rms`` (decay 0.9, eps 1e-8 inside the sqrt, second
    moment starting at 0) followed by ``scale(-lr)``; coupled weight decay
    added to the gradient first, as ``optax.add_decayed_weights``."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, decay: float = 0.9,
                 eps: float = 1e-8) -> None:
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, decay=decay, eps=eps))
        # made here, not at the first step, so that a captured step finds it
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["nu"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.add(p, alpha=group["weight_decay"]) if group["weight_decay"] else p.grad
                nu = self.state[p]["nu"]
                nu.mul_(group["decay"]).addcmul_(g, g, value=1.0 - group["decay"])
                p.addcmul_(g, torch.rsqrt(nu + group["eps"]), value=-group["lr"])


class _OptaxRSS(torch.optim.Optimizer):
    """optax ``scale_by_rss`` (sum of squares starting at 0.1, eps 1e-7
    inside the sqrt) followed by ``scale(-lr)``; coupled weight decay first."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> None:
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))
        # made here, not at the first step, so that a captured step finds it
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum_of_squares"] = torch.full_like(
                    p, group["initial_accumulator_value"])

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.add(p, alpha=group["weight_decay"]) if group["weight_decay"] else p.grad
                acc = self.state[p]["sum_of_squares"]
                acc.addcmul_(g, g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
                p.addcmul_(g, scale, value=-group["lr"])


def make_optimizer(params, train_cfg: Dict[str, Any],
                   capturable: bool = False) -> torch.optim.Optimizer:
    """torch-style optimizers (reference ``_get_optimizers``) matching the JAX
    package's optax chains: weight decay is coupled (added to the gradient
    before the update). adam and sgd are ``torch.optim``'s, which match
    ``scale_by_adam`` and ``identity``; rmsprop and adagrad follow optax's
    formulas, which differ from ``torch.optim``'s defaults. ``capturable``
    keeps Adam's step count on the device, so that a CUDA graph can hold
    its update (its bias corrections then round differently in the last
    bit)."""
    name = str(train_cfg.get("optimizer", "adam")).lower()
    lr = float(train_cfg.get("learning_rate", 1e-3))
    wd = float(train_cfg.get("weight_decay", 0.0) or 0.0)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=wd, capturable=capturable)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=wd)
    if name == "rmsprop":
        return _OptaxRMS(params, lr=lr, weight_decay=wd)
    if name == "adagrad":
        return _OptaxRSS(params, lr=lr, weight_decay=wd)
    raise ValueError(f"unknown optimizer {name!r}: adam, sgd, rmsprop or adagrad")


class Trainer:
    def __init__(
        self,
        config: Dict[str, Any],
        datasets: Tuple[SeqDataset, SeqDataset, SeqDataset],
        workdir: Optional[str] = None,
        device="cuda",
        mesh_plan: Optional[MeshPlan] = None,
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but CUDA is not available")
        self.config = config
        self.train_data, self.val_data, self.test_data = datasets
        self.workdir = workdir
        self.plan = mesh_plan or MeshPlan()

        self.model_name = config["model"]["model"]
        self.model_class = get_model_class(self.model_name)
        if getattr(self.model_class, "is_meta", False):
            raise ValueError(
                f"model {self.model_name!r} is the bilevel (DR4SR+) wrapper: train it with "
                f"dr4sr_tpu_torch.train.meta_trainer.MetaTrainer, which "
                f"dr4sr_tpu_torch.quickstart.make_trainer picks for it")
        cp = int(config["model"].get("context_parallel", 1))
        if cp > 1 and self.plan.model_size != cp:
            raise ValueError(
                f"model.context_parallel={cp} needs a mesh with a model axis of that size "
                f"(got {self.plan.data_size} x {self.plan.model_size})")
        cfg_t = config["train"]
        refuse_rng_impl(cfg_t)
        self.steps_per_dispatch = int(cfg_t.get("steps_per_dispatch", 1))
        if self.steps_per_dispatch < 1:
            raise ValueError(f"train.steps_per_dispatch must be at least 1, got "
                             f"{self.steps_per_dispatch}")
        if self.steps_per_dispatch > 1:
            refusal = capture_refusal(self.model_class, config)
            if refusal is not None:
                raise NotImplementedError(
                    f"train.steps_per_dispatch={self.steps_per_dispatch} with "
                    f"{self.model_name}: its step cannot be captured into a CUDA graph: "
                    f"{refusal}; use 1")
        prec = str(cfg_t.get("precision", "fp32")).lower()
        if prec not in ("fp32", "float32", "bf16", "bfloat16"):
            raise ValueError(f"train.precision must be fp32 or bf16, got {prec!r}")
        self.compute_dtype = torch.bfloat16 if prec.startswith("bf") else None
        self._refuse_on_mesh()
        # the plans installed around every step and eval: EP's (the table
        # row-sharded) and CP's (the ring over the model axis)
        self._ep_plan = self.plan if self.plan.ep_sharded() else None
        self._cp_plan = self.plan if cp > 1 else None
        self.data_axis = self.plan.axis(DATA_AXIS) if self.plan.data_size > 1 else None

        self.contrastive = bool(getattr(self.model_class, "contrastive", False))
        self.aug_from_original = bool(getattr(self.model_class, "aug_from_original", False))
        self.pre_padding = bool(getattr(self.model_class, "pre_padding", False))
        self.prefix_training = bool(getattr(self.model_class, "prefix_training", False)
                                    and config["data"].get("prefix_training", True))
        if self.prefix_training and self.train_data.rows().item_id.ndim == 2:
            # train rows become pre-padded per-prefix rows, as in the JAX trainer
            # (which fails on a dataset an earlier trainer expanded already)
            self.train_data.data = expand_prefix_rows(self.train_data.rows())
        self._original_data: Optional[SeqDataset] = None

        self.num_items = self.train_data.num_items
        self.num_users = self.train_data.num_users
        self.domain_name_list = self.train_data.domain_name_list
        self.training_time = 0.0
        self.inference_time = 0.0
        self.logged_metrics: Dict[str, float] = {}
        self.rec: Optional[RecModel] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.generator: Optional[torch.Generator] = None  # negatives
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        # per-model device constants merged into every device batch: the
        # graph's edges, and the state refresh_state refits every epoch
        self.batch_extras: Dict[str, torch.Tensor] = {}
        if getattr(self.model_class, "needs_graph", False):
            self._build_graph()
        # the epoch's loss sum, on the device; captured steps add to it by address
        self._loss_sum = torch.zeros((), device=self.device)
        self._graphs: Optional[StepGraphs] = None  # the fused groups' CUDA graphs
        self._eager_groups = bool(cfg_t.get("disable_jit"))
        self._tb_writer: Optional[SummaryWriter] = None

    @property
    def world_size(self) -> int:
        return self.plan.data_size * self.plan.model_size

    def _refuse_on_mesh(self) -> None:
        """The refusals at world size > 1, each with its reason."""
        if self.world_size == 1:
            return
        name = self.model_name
        if self.steps_per_dispatch > 1:
            raise NotImplementedError(
                f"train.steps_per_dispatch={self.steps_per_dispatch} at world size "
                f"{self.world_size}: a CUDA graph of the steps would hold the collectives "
                f"(the gradient all-reduce, the EP gathers, the ring), which the port "
                f"does not capture yet; use 1")
        if getattr(self.model_class, "contrastive", False) or getattr(
                self.model_class, "aux_loss", None) is not None:
            raise NotImplementedError(
                f"{name} at world size {self.world_size}: its contrastive or auxiliary "
                f"loss compares rows across the global batch (in-batch InfoNCE), which "
                f"needs an all-gather of the views that the port does not make yet")
        if self.plan.ep_sharded() and getattr(self.model_class, "needs_graph", False):
            raise NotImplementedError(
                f"{name} with a row-sharded item table: its graph propagation reads the "
                f"whole table; shard the batch (data parallelism) only")

    @contextlib.contextmanager
    def _mesh_plans(self):
        """The EP and CP plans of this trainer installed for the body."""
        with ep.ep_plan(self._ep_plan), ring_attention.context_plan(self._cp_plan):
            yield

    # ------------------------------------------------------------------ graph
    def _build_graph(self) -> None:
        """``model.graph`` 'old': the val rows without their last item;
        'new': the train rows; window ``model.window``."""
        cfg_m = self.config["model"]
        old = cfg_m.get("graph", "old") == "old"
        rows = (self.val_data if old else self.train_data).rows()
        row, col, weight = build_transition_graph(
            rows.in_item_id, rows.seqlen, self.num_items, window=int(cfg_m.get("window", 2)),
            drop_last=old)
        self.batch_extras = {"edge_row": torch.from_numpy(row).long().to(self.device),
                             "edge_col": torch.from_numpy(col).long().to(self.device),
                             "edge_weight": torch.from_numpy(weight).to(self.device)}

    # ------------------------------------------------------------------- init
    def init_state(self, seed: Optional[int] = None) -> RecModel:
        """Fresh weights from ``seed`` (default ``train.seed``), a fresh
        optimizer, and the step's generators seeded from ``seed + 1``. The
        weights are drawn on the CPU, so every device starts from the same."""
        seed = int(self.config["train"].get("seed", 2023)) if seed is None else seed
        with self._mesh_plans():  # under EP the table is declared padded
            module = self.model_class.build(self.config, self.num_items,
                                            generator=torch.Generator().manual_seed(seed))
        module = module.to(self.device)
        self._place(module)
        self.rec = RecModel(self.config, module, self.num_items, self.num_users,
                            data_axis=self.data_axis)
        self.optimizer = make_optimizer(module.parameters(), self.config["train"],
                                        capturable=self._captures)
        self._graphs = None
        self.step = 0
        # negatives from their own generator, in lockstep on every rank;
        # dropout from the default ones, apart on each data rank
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        data_index = 0 if self.data_axis is None else self.data_axis.index
        torch.manual_seed(seed + 1 + _DROPOUT_RANK_STRIDE * data_index)
        return self.rec

    def _place(self, module: torch.nn.Module) -> None:
        """Parameter placement under a mesh: every parameter takes rank 0's
        values; under EP the item table then keeps this rank's rows."""
        if self.plan.mesh is None:
            return
        replicate(module.parameters(), self.plan)
        if self._ep_plan is not None:
            emb = module.item_embedding
            emb.weight = torch.nn.Parameter(
                emb.weight.detach()[self.plan.row_slice(emb.weight.shape[0])].clone())

    def _local_table(self, table: torch.Tensor) -> torch.Tensor:
        """A full item table (or a per-row state of it), padded or not, cut
        or zero-padded to the module's rows and, under EP, to this rank's
        slice of the padded table."""
        local = self.rec.module.item_embedding.weight.shape[0]
        full = local * (self.plan.model_size if self._ep_plan else 1)
        table = table[:full]
        if table.shape[0] < full:
            table = torch.cat([table, table.new_zeros(full - table.shape[0], table.shape[1])])
        return table[self.plan.row_slice(full)] if self._ep_plan else table

    def _local_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A full state_dict (a checkpoint's, or :meth:`full_state_dict`'s) as
        this rank's module holds it (:meth:`_local_table`)."""
        if _TABLE not in params:
            return params
        return {**params, _TABLE: self._local_table(params[_TABLE])}

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's state_dict with a row-sharded table gathered over
        ``model`` (padded, as saved); on every rank."""
        state = self.rec.module.state_dict()
        if self._ep_plan is not None:
            state = dict(state)
            state[_TABLE] = all_gather(state[_TABLE], self.plan.axis(MODEL_AXIS), dim=0)
        return state

    def set_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Load a full state_dict (any table padding) into the module, as
        this rank holds it."""
        if self.rec is None:
            raise RuntimeError("call init_state() first")
        self.rec.module.load_state_dict(self._local_params(params))

    # ------------------------------------------------------------ batch plumbing
    def host_transform(self, batch: Dict[str, np.ndarray],
                       is_train: bool = False) -> Dict[str, np.ndarray]:
        """Pre-padding for a ``pre_padding`` model, except for train rows that
        were prefix-expanded (already pre-padded)."""
        if self.pre_padding and not (is_train and self.prefix_training):
            return pre_pad_batch(batch)
        return batch

    def host_shard(self, batch: Dict[str, np.ndarray],
                   is_train: bool = False) -> Dict[str, np.ndarray]:
        """:meth:`host_transform`, then under a mesh this rank's rows of the
        global batch padded to a multiple of the ``data`` axis."""
        batch = self.host_transform(batch, is_train)
        if self.plan.data_size > 1:
            batch = shard_batch(pad_batch_to_multiple(batch, self.plan.data_size), self.plan)
        return batch

    def device_batch(self, batch: Dict[str, np.ndarray],
                     is_train: bool = False) -> Dict[str, torch.Tensor]:
        """A host batch on the device, after :meth:`host_shard`."""
        return self._to_device(self.host_shard(batch, is_train))

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if t.dtype == torch.int32:
                t = t.long()
            out[k] = t.to(self.device, non_blocking=True)
        out.update(self.batch_extras)
        return out

    @property
    def _captures(self) -> bool:
        """Whether groups of steps are captured into CUDA graphs."""
        return (self.device.type == "cuda" and self.steps_per_dispatch > 1
                and not self._eager_groups)

    def _autocast(self):
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        # no cache of cast weights: it would not outlive a captured step
        return torch.autocast(self.device.type, dtype=self.compute_dtype, cache_enabled=False)

    # -------------------------------------------------------------- train step
    def loss(self, batch: Dict[str, torch.Tensor], neg_id: Optional[torch.Tensor] = None,
             views=None, aux_draws=None) -> torch.Tensor:
        """The training loss of a device batch (the JAX trainer's
        ``_loss_fn``): the main loss, plus ``cl_weight`` × the contrastive
        term for a ``contrastive`` model, over ``aug_*`` rows when the batch
        has them, plus the model's ``aux_loss``. Negatives, views and the
        aux term's draws come from :attr:`generator` unless ``neg_id``,
        ``views`` and ``aux_draws`` give them."""
        loss = self.rec.training_loss(batch, self.generator, neg_id=neg_id)
        if self.contrastive:
            valid = batch.get("aug_valid", batch.get("valid"))
            seq = batch.get("aug_in_item_id", batch["in_item_id"])
            if valid is None:
                valid = torch.ones(seq.shape[0], dtype=torch.bool, device=seq.device)
            model_cfg = self.config["model"]
            cl = cl_loss(self.rec.module, seq, batch.get("aug_seqlen", batch["seqlen"]), valid,
                         model_cfg, self.num_items, self.generator, views=views)
            loss = loss + float(model_cfg.get("cl_weight", 0.1)) * cl
        aux_loss = getattr(self.model_class, "aux_loss", None)
        if aux_loss is not None:
            model_cfg = self.config["model"]
            if aux_draws is None:
                aux_draws = self.model_class.aux_draws(self.generator, batch, model_cfg,
                                                       self.num_items)
            loss = loss + aux_loss(self.rec.module, batch, model_cfg, self.num_items, aux_draws)
        return loss.float()

    def _update(self, batch: Dict[str, torch.Tensor],
                neg_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step on a device batch, without the step count:
        what a CUDA graph of a group captures."""
        self.optimizer.zero_grad(set_to_none=True)
        with self._mesh_plans():
            with self._autocast():
                loss = self.loss(batch, neg_id=neg_id)
            loss.backward()
        loss = self._sum_over_data(loss.detach())
        self.optimizer.step()
        return loss

    def _sum_over_data(self, loss: torch.Tensor) -> torch.Tensor:
        """Under data parallelism, every gradient and the loss summed over
        the ``data`` group in one all-reduce (each rank's loss is its share
        of the global batch's); returns the global loss."""
        if self.data_axis is None:
            return loss
        grads = [p.grad for p in self.rec.module.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).float()])
        all_reduce_(flat, self.data_axis)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[-1]

    def train_step(self, batch: Dict[str, torch.Tensor],
                   neg_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss (on device;
        the global batch's under a mesh). ``neg_id`` gives the negatives (this
        rank's rows of the global batch's) in place of :attr:`generator`'s;
        the gradients stay in the parameters' ``grad`` until the next step."""
        loss = self._update(batch, neg_id)
        self.step += 1
        return loss

    def train_group(self, batches) -> None:
        """One dispatch of plain steps over host ``batches``, their losses
        added to the epoch's sum: a group of one as :meth:`train_step`, a
        longer one through :meth:`fused_steps`."""
        self._group(batches, self.train_step, "train", self._update)

    def _group(self, batches, step, kind: str, update) -> None:
        if len(batches) == 1:
            self._loss_sum.add_(step(self.device_batch(batches[0], is_train=True)))
        else:
            self.fused_steps(batches, kind, update)

    def fused_steps(self, batches, kind: str, update) -> torch.Tensor:
        """``len(batches)`` optimizer steps of ``update`` (a step without
        the step count) in one dispatch, as the JAX trainer's
        ``multi_train_step``: on the card one replay of the CUDA graph of
        ``kind``'s steps at this group length (:class:`fused.StepGraphs`),
        on the CPU the same steps one after another. Each loss is added to
        the epoch's sum; returns the [n] losses."""
        hosts = [self.host_transform(b, is_train=True) for b in batches]

        def step(batch):
            loss = update(batch)
            self._loss_sum.add_(loss)
            return loss

        if self._captures:
            if self._graphs is None:
                self._graphs = StepGraphs(self.generator, self.steps_per_dispatch)
            losses = self._graphs.run(kind, step, hosts, self.batch_extras)
        else:
            stacked = stack_batches(hosts)
            losses = torch.stack([step(b) for b in step_batches(stacked, self.batch_extras,
                                                                len(batches))])
        self.step += len(batches)
        return losses

    def train_batches(self, nepoch: int):
        """The host batches of epoch ``nepoch``; for an ``aug_from_original``
        model each carries ``aug_in_item_id``, ``aug_seqlen`` and ``aug_valid``
        from the original train rows, whose loader starts over when it runs
        out."""
        aug_iter = iter(self._original_loader(nepoch)) if self.aug_from_original else None
        for batch in self.train_data.get_loader(seed=nepoch):
            if aug_iter is not None:
                aug = next(aug_iter, None)
                if aug is None:
                    aug_iter = iter(self._original_loader(nepoch))
                    aug = next(aug_iter)
                batch = dict(batch, aug_in_item_id=aug["in_item_id"], aug_seqlen=aug["seqlen"],
                             aug_valid=aug["valid"])
            yield batch

    def _original_loader(self, nepoch: int):
        """A loader over the train rows of ``train_file = ""`` (the same
        dataset class, rebuilt once), shuffled from ``nepoch + 7919``."""
        if self._original_data is None:
            cfg = copy.deepcopy(self.config)
            cfg["data"]["train_file"] = ""
            ds = type(self.train_data)(cfg, phase="train", root=self.train_data.root)
            ds.build()
            self._original_data = ds
        return self._original_data.get_loader(batch_size=int(self.config["train"]["batch_size"]),
                                              seed=nepoch + _ORIGINAL_LOADER_SEED)

    def refresh_state(self, nepoch: int) -> None:
        """The model's per-epoch state (``refresh_state``: k-means
        prototypes or intents under the current weights) into
        :attr:`batch_extras`; nothing for a model without the hook. An
        entry of the same shape is copied in place (captured steps read it
        by address); any other drops the captured graphs."""
        refresh = getattr(self.model_class, "refresh_state", None)
        if refresh is None:
            return
        for key, value in refresh(self, nepoch).items():
            old = self.batch_extras.get(key)
            if (old is not None and old.shape == value.shape and old.dtype == value.dtype
                    and old.device == value.device):
                old.copy_(value)
            else:
                self.batch_extras[key] = value
                self._graphs = None

    def training_epoch(self, nepoch: int) -> float:
        """One epoch in groups of ``train.steps_per_dispatch`` batches
        (:meth:`train_group`); returns the mean loss."""
        if self.rec is None:
            raise RuntimeError("call init_state() first")
        self.refresh_state(nepoch)
        self.rec.module.train()
        self._loss_sum.zero_()
        n_steps = 0
        batches = self.train_batches(nepoch)
        while group := list(itertools.islice(batches, self.steps_per_dispatch)):
            self.train_group(group)
            n_steps += len(group)
        return float(self._loss_sum) / max(n_steps, 1)

    # --------------------------------------------------------------- eval step
    @torch.no_grad()
    def eval_topk(self, batch, keep_mask, rec: Optional[RecModel] = None):
        """(scores, items) [B, eval.topk] of a device batch (this rank's
        rows), over the whole catalog; under EP through
        ``sharded_masked_topk``."""
        rec = rec or self.rec
        k = int(self.config["eval"]["topk"])
        with self._mesh_plans():
            if self._ep_plan is None:
                return rec.topk(batch, k, item_keep_mask=keep_mask)
            # the padded rows' keep_mask is False, so they never surface
            table = item_table(rec.module)
            keep = torch.zeros(table.shape[0] * self.plan.model_size, dtype=torch.bool,
                               device=keep_mask.device)
            keep[: self.num_items] = keep_mask
            return sharded_masked_topk(
                rec.encode_eval(batch), table, min(k, self.num_items),
                self.plan.axis(MODEL_AXIS), keep[self.plan.row_slice(keep.shape[0])],
                batch.get("user_hist"))

    @torch.no_grad()
    def _eval_metrics(self, rec: RecModel, batch, keep_mask) -> Dict[str, torch.Tensor]:
        cfg_e = self.config["eval"]
        cutoffs = tuple(int(c) for c in cfg_e["cutoff"])
        _, topk_items = self.eval_topk(batch, keep_mask, rec)
        pred = batch["item_id"][:, None] == topk_items  # [B, k] bool
        return evaluation.compute_rank_metrics(pred, batch["label"], cfg_e["val_metrics"],
                                               cutoffs)

    def _eval_epoch(self, dataset: SeqDataset, domain: str, rec: Optional[RecModel] = None,
                    with_analyzer: bool = False) -> Dict[str, float]:
        """Metrics over ``domain``'s rows, averaged over the valid rows; the
        sums stay on the device until the end, where under data parallelism
        they and the count are summed over ``data`` in one all-reduce.
        ``with_analyzer`` also buckets the per-sample metrics by history
        length (``self._last_analyzer``; this rank's rows)."""
        rec = rec or self.rec
        dataset.set_eval_domain(domain)
        keep_mask = torch.from_numpy(dataset.domain_item_mask(domain)).to(self.device)
        sums: Dict[str, torch.Tensor] = {}
        count = torch.zeros((), device=self.device)
        analyzer = Analyzer() if with_analyzer else None
        for batch in dataset.get_loader():
            batch = self.host_shard(batch)
            dbatch = self._to_device(batch)
            per_sample = self._eval_metrics(rec, dbatch, keep_mask)
            valid = dbatch["valid"]
            for k, v in per_sample.items():
                part = torch.where(valid, v, 0.0).sum()
                sums[k] = part if k not in sums else sums[k] + part
            count += valid.sum()
            if analyzer is not None:
                host = {k: v.cpu().numpy() for k, v in per_sample.items()}
                analyzer.record_batch(batch["seqlen"], host, batch["valid"])
        if analyzer is not None:
            self._last_analyzer = analyzer
        names = list(sums)
        totals = torch.stack([sums[k] for k in names] + [count.float()])
        if self.data_axis is not None:
            all_reduce_(totals, self.data_axis)
        totals = totals.tolist()
        denom = max(totals[-1], 1.0)
        return {k: v / denom for k, v in zip(names, totals)}

    def _eval_domains(self, dataset: SeqDataset, rec: Optional[RecModel] = None,
                      with_analyzer: bool = False) -> Dict[str, float]:
        """Metrics of every domain (``<domain>_<metric>``) and their sums."""
        output: Dict[str, float] = {}
        domain_sums: Dict[str, float] = defaultdict(float)
        for domain in self.domain_name_list:
            for k, v in self._eval_epoch(dataset, domain, rec, with_analyzer).items():
                output[f"{domain}_{k}"] = v
                domain_sums[k] += v
        output.update(domain_sums)
        return output

    def validate(self) -> Dict[str, float]:
        """Validation metrics of the current params: one pass over the
        validation rows, as each epoch of :meth:`fit` makes."""
        return self._eval_domains(self.val_data)

    def _rec_with(self, params: Optional[Dict[str, torch.Tensor]]) -> RecModel:
        """The model with ``params`` loaded into a copy of the module."""
        if params is None:
            return self.rec
        # ``to`` re-flattens a GRU's weights for cuDNN, which a deepcopy does not
        module = copy.deepcopy(self.rec.module).to(self.device)
        module.load_state_dict(self._local_params(params))
        return dataclasses.replace(self.rec, module=module)

    # ------------------------------------------------------------ observability
    def _save_base(self) -> str:
        return self.workdir or self.config["eval"].get("save_path", "saved")

    def run_dir(self) -> str:
        return os.path.join(self._save_base(), self.model_name, self.config["data"]["dataset"])

    def _log_metrics_jsonl(self, record: Dict[str, Any]) -> None:
        """Append per-epoch metrics to ``<workdir>/<model>/<dataset>/metrics.jsonl``
        (the reference logs to wandb at ``model/basemodel.py:149,400``)."""
        path = os.path.join(self.run_dir(), "metrics.jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        clean = {k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
                 for k, v in record.items()}
        with open(path, "a") as f:
            f.write(json.dumps(clean) + "\n")
        tb_dir = self.config["train"].get("tensorboard_dir")
        if tb_dir:
            if self._tb_writer is None:
                self._tb_writer = SummaryWriter(tb_dir)
            step = int(record.get("epoch", 0))
            for k, v in clean.items():
                if isinstance(v, float):
                    self._tb_writer.add_scalar(k, v, step)

    def _maybe_profile(self, nepoch: int):
        """A ``torch.profiler`` session over epoch ``nepoch``'s training when
        it is ``train.profile_epoch``: CPU ops, and on the card its kernels
        (graph replays included); on exit one trace a rank goes to
        ``train.profile_dir`` (default ``<temp dir>/dr4sr_profile``)."""
        cfg_t = self.config["train"]
        if nepoch != cfg_t.get("profile_epoch"):
            return contextlib.nullcontext()
        out = cfg_t.get("profile_dir") or os.path.join(tempfile.gettempdir(), "dr4sr_profile")
        logger.info(f"profiling epoch {nepoch} -> {out}")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                out, worker_name=f"rank{process_index()}"))

    # --------------------------------------------------------- fault tolerance
    def _state_path(self) -> str:
        return os.path.join(self.run_dir(), "state_latest.pt")

    def _table_moments(self, state: Dict[str, Any], fn) -> Dict[str, Any]:
        """An optimizer state_dict with ``fn`` applied to the item table's
        per-row state tensors (Adam's moments): gathered to save, cut to this
        rank's rows to load. Identity without EP."""
        if self._ep_plan is None:
            return state
        params = list(self.rec.module.parameters())
        idx = next(i for i, p in enumerate(params) if p is self.rec.module.item_embedding.weight)
        if idx not in state["state"]:
            return state
        moments = {k: fn(v) if torch.is_tensor(v) and v.dim() == 2 else v
                   for k, v in state["state"][idx].items()}
        return {**state, "state": {**state["state"], idx: moments}}

    def save_train_state(self, epoch: int) -> None:
        """Resumable snapshot: params, optimizer state, step, epoch and the
        generators' states (the reference keeps only the best params). Under
        a mesh the table and its moments are gathered and process 0 writes,
        with every rank's dropout generator state."""
        model = self.plan.axis(MODEL_AXIS)
        params = self.full_state_dict()
        optim = self._table_moments(self.optimizer.state_dict(),
                                    lambda t: all_gather(t, model, dim=0))
        rngs = (torch.get_rng_state(),
                torch.cuda.get_rng_state(self.device) if self.device.type == "cuda" else None)
        rank_rngs = gather_objects(rngs, self.plan.world)
        if process_index() != 0:
            return
        path = self._state_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "params": params,
            "optimizer": optim,
            "step": self.step,
            "epoch": int(epoch),
            "generator": self.generator.get_state(),
            "torch_rng": rngs[0],
        }
        if self.world_size > 1:
            payload["rank_torch_rng"] = [r[0] for r in rank_rngs]
        if self.device.type == "cuda":
            payload["cuda_rng"] = rngs[1]
            if self.world_size > 1:
                payload["rank_cuda_rng"] = [r[1] for r in rank_rngs]
        torch.save(payload, path)

    def restore_train_state(self) -> Optional[int]:
        """Returns the epoch to resume from, or None if no snapshot exists."""
        path = self._state_path()
        if not os.path.exists(path):
            return None
        if self.rec is None:
            self.init_state()
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.set_params(payload["params"])
        self.optimizer.load_state_dict(  # rebinds its state
            self._table_moments(payload["optimizer"], self._local_table))
        self._graphs = None
        self.step = int(payload["step"])
        self.generator.set_state(payload["generator"])
        rank = process_index()
        torch.set_rng_state(payload.get("rank_torch_rng", {rank: payload["torch_rng"]})[rank])
        if "cuda_rng" in payload and self.device.type == "cuda":
            cuda_rng = payload.get("rank_cuda_rng", {rank: payload["cuda_rng"]})[rank]
            torch.cuda.set_rng_state(cuda_rng, self.device)
        return int(payload["epoch"]) + 1

    # ----------------------------------------------------------------- fit/eval
    def fit(self, resume: bool = False) -> Dict[str, float]:
        cfg_t = self.config["train"]
        monitor = f"ndcg@{int(self.config['eval']['cutoff'][0])}"
        callback = EarlyStopping(
            monitor,
            self.config["data"]["dataset"],
            self.model_name,
            save_dir=self._save_base(),
            patience=int(cfg_t.get("early_stop_patience", 10)),
            mode=cfg_t.get("early_stop_mode", "max"),
        )
        if self.rec is None:
            self.init_state()
        start_epoch = 0
        if resume:
            resumed = self.restore_train_state()
            if resumed is not None:
                start_epoch = resumed
                logger.info(f"resumed training from epoch {start_epoch}")

        ckpt_every = int(cfg_t.get("checkpoint_every_epochs", 0) or 0)
        for nepoch in range(start_epoch, int(cfg_t["epochs"])):
            self.logged_metrics = {"epoch": nepoch}
            tik = time.perf_counter()
            with self._maybe_profile(nepoch):
                train_loss = self.training_epoch(nepoch)
            self.training_time += time.perf_counter() - tik
            self.logged_metrics["train_loss"] = train_loss
            if ckpt_every and (nepoch + 1) % ckpt_every == 0:
                self.save_train_state(nepoch)

            tik = time.perf_counter()
            analyze = nepoch % 10 == 0
            self.logged_metrics.update(self._eval_domains(self.val_data, with_analyzer=analyze))
            self.inference_time += time.perf_counter() - tik

            logger.info(f"epoch {nepoch}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in self.logged_metrics.items() if isinstance(v, float)))
            if process_index() == 0:
                self._log_metrics_jsonl(self.logged_metrics)
            if analyze:
                logger.info(f"analyzer (by history length): {self._last_analyzer.summary()}")
                # the reference's wandb figure (utils/callbacks.py:161-198)
                if process_index() == 0:
                    self._last_analyzer.plot(
                        os.path.join(self.run_dir(), "figures", f"epoch_{nepoch}.png"))
            if callback(self.full_state_dict(), self.config, nepoch, self.logged_metrics):
                break
        if self._tb_writer is not None:
            self._tb_writer.close()
            self._tb_writer = None
        self.callback = callback
        self.best_params = callback.best_params or {
            k: v.detach().to("cpu", copy=True) for k, v in self.full_state_dict().items()}
        return self.logged_metrics

    def evaluate(self) -> Dict[str, float]:
        """Test metrics with the best checkpointed params
        (reference ``BaseModel.evaluate``, ``model/basemodel.py:370-402``)."""
        output = self._eval_domains(self.test_data, self._rec_with(self.best_params),
                                    with_analyzer=True)
        logger.info(f"test: {output}")
        logger.info(f"training_time: {self.training_time:.1f}s "
                    f"inference_time: {self.inference_time:.1f}s")
        return output

    def load_best_from(self, path: str) -> None:
        """Take the best params from a checkpoint of this package."""
        if self.rec is None:
            raise RuntimeError("call init_state() first")
        params, _ = load_checkpoint(path)
        self._rec_with(params)  # checks the keys and shapes
        self.best_params = params
