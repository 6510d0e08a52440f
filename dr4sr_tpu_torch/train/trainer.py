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

Not ported yet, and refused with a clear error: the bilevel trainer
(``is_meta``: DR4SR+), ``model.context_parallel > 1`` (the multi-GPU
slice), ``train.steps_per_dispatch > 1`` (a later CUDA-graph PR),
``train.tensorboard_dir`` and ``train.profile_epoch``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import logging
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dr4sr_tpu_torch import evaluation
from dr4sr_tpu_torch.data.dataset import SeqDataset
from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.cl4srec import cl_loss
from dr4sr_tpu_torch.models.fmlp import expand_prefix_rows, pre_pad_batch
from dr4sr_tpu_torch.models.gnn import build_transition_graph
from dr4sr_tpu_torch.train.callbacks import Analyzer, EarlyStopping
from dr4sr_tpu_torch.train.checkpoint import load_checkpoint

logger = logging.getLogger("dr4sr_tpu_torch")

# model-class flags whose code paths this package has not ported yet
_UNPORTED_MODEL_FLAGS = ("is_meta",)
# CL4SRec2's views read the original train file with this seed offset
_ORIGINAL_LOADER_SEED = 7919
_UNPORTED_TRAIN_KEYS = ("tensorboard_dir", "profile_epoch")


class _OptaxRMS(torch.optim.Optimizer):
    """optax ``scale_by_rms`` (decay 0.9, eps 1e-8 inside the sqrt, second
    moment starting at 0) followed by ``scale(-lr)``; coupled weight decay
    added to the gradient first, as ``optax.add_decayed_weights``."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, decay: float = 0.9,
                 eps: float = 1e-8) -> None:
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.add(p, alpha=group["weight_decay"]) if group["weight_decay"] else p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
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

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.add(p, alpha=group["weight_decay"]) if group["weight_decay"] else p.grad
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
                acc = state["sum_of_squares"]
                acc.addcmul_(g, g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
                p.addcmul_(g, scale, value=-group["lr"])


def make_optimizer(params, train_cfg: Dict[str, Any]) -> torch.optim.Optimizer:
    """torch-style optimizers (reference ``_get_optimizers``) matching the JAX
    package's optax chains: weight decay is coupled (added to the gradient
    before the update). adam and sgd are ``torch.optim``'s, which match
    ``scale_by_adam`` and ``identity``; rmsprop and adagrad follow optax's
    formulas, which differ from ``torch.optim``'s defaults."""
    name = str(train_cfg.get("optimizer", "adam")).lower()
    lr = float(train_cfg.get("learning_rate", 1e-3))
    wd = float(train_cfg.get("weight_decay", 0.0) or 0.0)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=wd)
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
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but CUDA is not available")
        self.config = config
        self.train_data, self.val_data, self.test_data = datasets
        self.workdir = workdir

        self.model_name = config["model"]["model"]
        self.model_class = get_model_class(self.model_name)
        for flag in _UNPORTED_MODEL_FLAGS:
            if getattr(self.model_class, flag, None):
                raise NotImplementedError(
                    f"model {self.model_name!r} needs '{flag}', which dr4sr_tpu_torch does "
                    f"not port yet (DR4SR+ comes in a later slice); use the JAX package")
        cp = int(config["model"].get("context_parallel", 1))
        if cp > 1:
            raise NotImplementedError(
                f"model.context_parallel={cp} needs a mesh, which comes with the multi-GPU "
                f"slice of dr4sr_tpu_torch; use 1 or the JAX package")
        cfg_t = config["train"]
        for key in _UNPORTED_TRAIN_KEYS:
            if cfg_t.get(key) is not None:
                raise NotImplementedError(f"train.{key} is not ported to dr4sr_tpu_torch yet")
        if int(cfg_t.get("steps_per_dispatch", 1)) > 1:
            raise NotImplementedError(
                "train.steps_per_dispatch > 1 waits for the CUDA-graph port; use 1")
        prec = str(cfg_t.get("precision", "fp32")).lower()
        if prec not in ("fp32", "float32", "bf16", "bfloat16"):
            raise ValueError(f"train.precision must be fp32 or bf16, got {prec!r}")
        self.compute_dtype = torch.bfloat16 if prec.startswith("bf") else None

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
        module = self.model_class.build(self.config, self.num_items,
                                        generator=torch.Generator().manual_seed(seed))
        self.rec = RecModel(self.config, module.to(self.device), self.num_items, self.num_users)
        self.optimizer = make_optimizer(module.parameters(), self.config["train"])
        self.step = 0
        # negatives from their own generator; dropout from the default ones
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        torch.manual_seed(seed + 1)
        return self.rec

    # ------------------------------------------------------------ batch plumbing
    def host_transform(self, batch: Dict[str, np.ndarray],
                       is_train: bool = False) -> Dict[str, np.ndarray]:
        """Pre-padding for a ``pre_padding`` model, except for train rows that
        were prefix-expanded (already pre-padded)."""
        if self.pre_padding and not (is_train and self.prefix_training):
            return pre_pad_batch(batch)
        return batch

    def device_batch(self, batch: Dict[str, np.ndarray],
                     is_train: bool = False) -> Dict[str, torch.Tensor]:
        """A host batch on the device, after :meth:`host_transform`."""
        batch = self.host_transform(batch, is_train)
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if t.dtype == torch.int32:
                t = t.long()
            out[k] = t.to(self.device, non_blocking=True)
        out.update(self.batch_extras)
        return out

    def _autocast(self):
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

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

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss (on device)."""
        self.optimizer.zero_grad(set_to_none=True)
        with self._autocast():
            loss = self.loss(batch)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

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
        :attr:`batch_extras`; nothing for a model without the hook."""
        refresh = getattr(self.model_class, "refresh_state", None)
        if refresh is not None:
            self.batch_extras.update(refresh(self, nepoch))

    def training_epoch(self, nepoch: int) -> float:
        if self.rec is None:
            raise RuntimeError("call init_state() first")
        self.refresh_state(nepoch)
        self.rec.module.train()
        total = torch.zeros((), device=self.device)
        n_steps = 0
        for batch in self.train_batches(nepoch):
            total += self.train_step(self.device_batch(batch, is_train=True))
            n_steps += 1
        return float(total) / max(n_steps, 1)

    # --------------------------------------------------------------- eval step
    @torch.no_grad()
    def _eval_metrics(self, rec: RecModel, batch, keep_mask) -> Dict[str, torch.Tensor]:
        cfg_e = self.config["eval"]
        cutoffs = tuple(int(c) for c in cfg_e["cutoff"])
        _, topk_items = rec.topk(batch, int(cfg_e["topk"]), item_keep_mask=keep_mask)
        pred = batch["item_id"][:, None] == topk_items  # [B, k] bool
        return evaluation.compute_rank_metrics(pred, batch["label"], cfg_e["val_metrics"],
                                               cutoffs)

    def _eval_epoch(self, dataset: SeqDataset, domain: str, rec: Optional[RecModel] = None,
                    with_analyzer: bool = False) -> Dict[str, float]:
        """Metrics over ``domain``'s rows, averaged over the valid rows; the
        sums stay on the device until the end. ``with_analyzer`` also buckets
        the per-sample metrics by history length (``self._last_analyzer``)."""
        rec = rec or self.rec
        dataset.set_eval_domain(domain)
        keep_mask = torch.from_numpy(dataset.domain_item_mask(domain)).to(self.device)
        sums: Dict[str, torch.Tensor] = {}
        count = torch.zeros((), device=self.device)
        analyzer = Analyzer() if with_analyzer else None
        for batch in dataset.get_loader():
            dbatch = self.device_batch(batch)
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
        denom = max(float(count), 1.0)
        return {k: float(v) / denom for k, v in sums.items()}

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
        module.load_state_dict(params)
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

    # --------------------------------------------------------- fault tolerance
    def _state_path(self) -> str:
        return os.path.join(self.run_dir(), "state_latest.pt")

    def save_train_state(self, epoch: int) -> None:
        """Resumable snapshot: params, optimizer state, step, epoch and the
        generators' states (the reference keeps only the best params)."""
        path = self._state_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "params": self.rec.module.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "epoch": int(epoch),
            "generator": self.generator.get_state(),
            "torch_rng": torch.get_rng_state(),
        }
        if self.device.type == "cuda":
            payload["cuda_rng"] = torch.cuda.get_rng_state(self.device)
        torch.save(payload, path)

    def restore_train_state(self) -> Optional[int]:
        """Returns the epoch to resume from, or None if no snapshot exists."""
        path = self._state_path()
        if not os.path.exists(path):
            return None
        if self.rec is None:
            self.init_state()
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.rec.module.load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        self.generator.set_state(payload["generator"])
        torch.set_rng_state(payload["torch_rng"])
        if "cuda_rng" in payload and self.device.type == "cuda":
            torch.cuda.set_rng_state(payload["cuda_rng"], self.device)
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
            self._log_metrics_jsonl(self.logged_metrics)
            if analyze:
                logger.info(f"analyzer (by history length): {self._last_analyzer.summary()}")
            if callback(self.rec.module.state_dict(), self.config, nepoch, self.logged_metrics):
                break
        self.callback = callback
        self.best_params = callback.best_params or {
            k: v.detach().to("cpu", copy=True) for k, v in self.rec.module.state_dict().items()}
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
