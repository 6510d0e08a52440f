"""MetaTrainer — the bilevel (DR4SR+) training loop.

Port of ``dr4sr_tpu/train/meta_trainer.py``; the behavioural spec is in
``dr4sr_tpu_torch.models.metamodel``. The trainer is the sub-model's
:class:`Trainer` plus:

* the meta parameters: the meta MLP (``modules.layers.MLP``, D → D → 2) and
  τ, with their own optimizer (SGD with momentum 0.9, or Adam);
* weighted inner steps (:meth:`MetaTrainer.weighted_train_step`): the
  gradient reaches the sub-model's parameters only, also through the
  weights' dependence on the query; the meta parameters enter detached;
* the outer step (:meth:`MetaTrainer.outer_step`): the implicit
  hypergradient (``meta.hypergrad``) of a val-proxy batch's unweighted loss
  through a train batch's weighted loss, under
  ``ops.attention.plain_attention()`` (the kernels' backward is once
  differentiable) and with cuDNN off (its RNN has no double backward, the
  reference's own workaround, ``model/metamodel.py:125,176``).

As in the JAX package: warm epochs (``nepoch <= warmup_epoch``) take the
base train step; the weighted steps run in f32 and add no ``aux_loss``;
``step_counter`` runs across epochs and the outer step fires after the
increment whenever it is a multiple of ``interval``; the outer loop's
batches, and the probe of the per-epoch weight statistics, come from
``sample_batch`` of a loader seeded ``nepoch + 4099``; epochs read the
plain train loader, so CL4SRec2's views come from the batch's own rows.
:meth:`Trainer.save_train_state` keeps the sub-model's state only.

Random draws (negatives, Gumbel noise, contrastive views) come from the
trainer's generator unless the caller passes them, so the CPU tests can
feed the JAX package's draws in.

On a mesh (data and embedding parallelism; context parallelism is
refused, as in the JAX package): the weighted step sums its gradients and
loss over ``data`` as the plain step does, its Gumbel noise is drawn for
the global batch in lockstep and cut to the rank's rows, and ``mean``
divides by the global count of weightable positions; the outer step's
hypergradient sums each of its derivatives over ``data``
(``meta.hypergrad``), so the meta parameters take one update, the same on
every rank; the probe's statistics are over the global batch.

A sub-model with an ``aux_loss`` (SGL, SimGCL) adds it in the warm steps,
which are the plain step, and leaves it out of the weighted loss, as the
JAX package does. A sub-model with per-epoch state (``refresh_state``:
NCL, ICLRec) is refused: the JAX package's bilevel epoch never refreshes
it, and its first step fails on the missing state.

``train.steps_per_dispatch = N > 1`` groups the inner steps as the JAX
trainer's fused loop does: outside warm-up a group stops at the next
``interval`` boundary, so the outer step between groups sees the state the
per-step loop would; warm groups replay the plain step's CUDA graph and
weighted groups a weighted step's (``train.fused``), which reads the meta
parameters in place; the outer step runs eagerly between groups. On a
mesh (DP, EP) the weighted groups' graphs hold their steps' collectives
as the plain step's do, and the outer step's collectives run eagerly
between them.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Any, Dict, Optional, Tuple

import torch

from dr4sr_tpu_torch.config import load_config
from dr4sr_tpu_torch.data.dataset import SeqDataset
from dr4sr_tpu_torch.meta.hypergrad import clip_by_global_norm, hypergradient
from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.models.metamodel import gumbel_softmax_weight
from dr4sr_tpu_torch.modules.layers import MLP
from dr4sr_tpu_torch.modules.losses import global_count
from dr4sr_tpu_torch.ops.attention import plain_attention
from dr4sr_tpu_torch.parallel.collectives import all_gather
from dr4sr_tpu_torch.regen.generator import gumbel_noise
from dr4sr_tpu_torch.train.trainer import Trainer

Batch = Dict[str, torch.Tensor]
# the meta loader's seed offset from the epoch
_META_LOADER_SEED = 4099
_OUTER_TRUNCATE_ITER = 3
_OUTER_CLIP_NORM = 10.0


@contextlib.contextmanager
def _cudnn_off():
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


class MetaTrainer(Trainer):
    """Bilevel trainer: weighted inner sub-model steps and periodic outer
    implicit-gradient meta updates."""

    def __init__(
        self,
        config: Dict[str, Any],
        datasets: Tuple[SeqDataset, SeqDataset, SeqDataset],
        workdir: Optional[str] = None,
        device="cuda",
        config_dir: Optional[str] = None,
        sub_config: Optional[Dict[str, Any]] = None,
        mesh_plan=None,
    ) -> None:
        """``config`` is the MetaModel config. The sub-model's comes from
        ``configs/<sub_model>.yaml`` with the CLI's explicit overrides
        (``config["_cli_overrides"]``, stashed by ``run.py``) applied, unless
        ``sub_config`` gives it ready; either way it takes ``config``'s data
        section, so the sub-model trains on the same files."""
        if sub_config is None:
            sub_config = load_config(config["model"]["sub_model"], config["data"]["dataset"],
                                     config_dir=config_dir,
                                     overrides=config.get("_cli_overrides"))
        else:
            sub_config = copy.deepcopy(sub_config)
        sub_config["data"] = copy.deepcopy(config["data"])
        self.meta_config = config
        if int(sub_config["model"].get("context_parallel", 1)) > 1:
            raise ValueError(
                "MetaModel (bilevel) does not support model.context_parallel>1: the "
                "hypergradient's second derivatives run through plain attention, and a "
                "context-parallel ring has no such route. Train the sub-model with CP "
                "directly, or drop CP for the bilevel run.")
        sub_name = sub_config["model"]["model"]
        if getattr(get_model_class(sub_name), "refresh_state", None) is not None:
            raise NotImplementedError(
                f"sub_model {sub_name!r}: its aux_loss reads per-epoch state that "
                f"refresh_state fits (k-means centroids), and the JAX package's bilevel "
                f"epoch (dr4sr_tpu/train/meta_trainer.py:308-370) never calls it, so its "
                f"first step fails with a KeyError; DR4SR+ is ported for SASRec, GRU4Rec, "
                f"FMLP, GNN, the CL4SRec models, SGL and SimGCL")
        super().__init__(sub_config, datasets, workdir=workdir, device=device, mesh_plan=mesh_plan)
        self.model_name = "MetaModel"

        cfg_t, cfg_m = config["train"], config["model"]
        self.interval = int(cfg_t.get("interval", 30))
        self.warmup_epoch = int(cfg_t.get("warmup_epoch", 10))
        self.tau_min = float(cfg_m.get("tau_min", 1.0))
        self.hpo_lr = float(cfg_t.get("hpo_learning_rate", 1e-3))
        # 'sum' is the reference arithmetic (Σ weight·loss); 'mean' divides
        # by the number of weightable positions, keeping the inner objective
        # on the warm steps' scale
        self.inner_scale = str(cfg_t.get("inner_loss_scale", "sum"))
        if self.inner_scale not in ("sum", "mean"):
            raise ValueError(f"train.inner_loss_scale must be sum or mean, got "
                             f"{self.inner_scale!r}")
        self.meta_module: Optional[MLP] = None
        self.tau: Optional[torch.Tensor] = None
        self.meta_optimizer: Optional[torch.optim.Optimizer] = None
        self.step_counter = 0

    # ------------------------------------------------------------------ state
    def init_state(self, seed: Optional[int] = None):
        """The sub-model's state (:meth:`Trainer.init_state`), then the meta
        MLP from its own generator seeded ``seed + 101`` (``seed`` the
        argument, 0 when None, as the JAX trainer seeds it), τ =
        ``model.tau_init`` (default 10, the reference's) and the meta
        optimizer."""
        rec = super().init_state(seed)
        d = int(self.config["model"]["embed_dim"])
        gen = torch.Generator().manual_seed((seed or 0) + 101)
        self.meta_module = MLP(d, (d, 2), generator=gen).to(self.device)
        tau_init = float(self.meta_config["model"].get("tau_init", 10.0))
        self.tau = torch.tensor(tau_init, device=self.device, requires_grad=True)
        self.meta_optimizer = self._make_meta_optimizer()
        return rec

    @property
    def meta_params(self) -> Dict[str, torch.Tensor]:
        """The meta parameters, live: the meta MLP's by name, and ``tau``."""
        return {**dict(self.meta_module.named_parameters()), "tau": self.tau}

    def load_meta(self, mlp_state: Dict[str, torch.Tensor], tau: float) -> None:
        """Copy meta parameters in (e.g. ``convert.meta_params_from_jax``)."""
        self.meta_module.load_state_dict(mlp_state)
        with torch.no_grad():
            self.tau.fill_(tau)
        self._graphs = None

    def _make_meta_optimizer(self) -> torch.optim.Optimizer:
        """sgd: coupled weight decay, momentum 0.9 (optax
        ``add_decayed_weights`` → ``trace(0.9)`` → ``scale(-lr)``); any
        other name: Adam without weight decay (``scale_by_adam``), as the
        JAX trainer builds them."""
        cfg = self.meta_config["train"]
        lr = float(cfg.get("meta_learning_rate", 1e-3))
        params = list(self.meta_params.values())
        if str(cfg.get("meta_optimizer", "sgd")).lower() == "sgd":
            wd = float(cfg.get("meta_weight_decay", 0.0) or 0.0)
            return torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=wd)
        return torch.optim.Adam(params, lr=lr)

    # ------------------------------------------------------------------- losses
    def _weights(self, query: torch.Tensor, meta: Dict[str, torch.Tensor],
                 noise: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(per-query weights, τ clipped at ``tau_min``) from the meta
        parameters ``meta``; Gumbel noise from the generator unless given."""
        mlp = {k: v for k, v in meta.items() if k != "tau"}
        logits = torch.func.functional_call(self.meta_module, mlp, (query,))
        # torch.maximum, as jnp.clip: half the gradient at a tie; the bound
        # filled on the device (a host scalar copied in would not capture)
        tau = torch.maximum(meta["tau"], torch.full_like(meta["tau"], self.tau_min))
        if noise is None:
            axis = self.data_axis
            if axis is None:
                noise = gumbel_noise(logits.shape, self.generator, logits.device)
            else:  # the global batch's draws, this rank's rows
                noise = axis.chunk(gumbel_noise((logits.shape[0] * axis.size,) + logits.shape[1:],
                                                self.generator, logits.device), 0)
        return gumbel_softmax_weight(logits, tau, noise), tau

    def _weighted_loss(self, batch: Batch, meta: Dict[str, torch.Tensor],
                       neg_id: Optional[torch.Tensor] = None, views=None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The inner objective (reference ``MetaModel.training_step:174-194``):
        Σ weight · per-position loss, plus, for a contrastive sub-model,
        ``cl_weight`` × its InfoNCE term unweighted. The weight has the
        query's shape ([B, L] for SASRec, [B] for FMLP); pattern rows
        (``user_id == 0``) weigh 1, padding and invalid rows 0."""
        loss_ps, query = self.rec.training_loss(batch, self.generator, neg_id=neg_id,
                                                reduce=False, return_query=True)
        weight, _ = self._weights(query, meta, noise)
        if weight.dim() > loss_ps.dim():
            weight = weight[..., 0]
        user_mask = batch["user_id"] == 0  # pattern rows: weight 1
        while user_mask.dim() < weight.dim():
            user_mask = user_mask[..., None]
        weight = torch.where(user_mask, 1.0, weight)
        pad = batch["item_id"] == 0
        if pad.dim() == weight.dim():
            weight = torch.where(pad, 0.0, weight)
        elif pad.dim() > weight.dim():  # [B] weight vs [B, L] loss
            weight = torch.where(pad, 0.0, weight[:, None] if weight.dim() == 1 else weight)
        valid = batch.get("valid")
        if valid is not None:
            weight = torch.where(valid.reshape(valid.shape + (1,) * (weight.dim() - valid.dim())),
                                 weight, 0.0)
        total = (weight * loss_ps).sum()
        if self.inner_scale == "mean":
            weightable = (~pad).expand(torch.broadcast_shapes(pad.shape, loss_ps.shape))
            if valid is not None:
                weightable = weightable & valid.reshape(
                    valid.shape + (1,) * (weightable.dim() - valid.dim()))
            total = total / global_count(weightable.float(), self.data_axis)
        if self.contrastive:
            total = total + self.contrastive_term(batch, views)
        return total

    # -------------------------------------------------------------------- steps
    def _weighted_update(self, batch: Batch, neg_id: Optional[torch.Tensor] = None,
                         views=None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step of the sub-model on the weighted loss, the
        meta parameters detached (views of their storage, which a captured
        step reads in place), without the step count."""
        self.optimizer.zero_grad(set_to_none=True)
        meta = {k: v.detach() for k, v in self.meta_params.items()}
        with self._mesh_plans():
            loss = self._weighted_loss(batch, meta, neg_id=neg_id, views=views, noise=noise)
            loss.backward()
        loss = self._sum_over_data(loss.detach())
        self.optimizer.step()
        return loss

    def weighted_train_step(self, batch: Batch, neg_id: Optional[torch.Tensor] = None,
                            views=None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step of the sub-model on the weighted loss, the
        meta parameters detached; returns the loss (on device)."""
        loss = self._weighted_update(batch, neg_id=neg_id, views=views, noise=noise)
        self.step += 1
        return loss

    def weighted_group(self, batches) -> None:
        """:meth:`Trainer.train_group` for weighted steps: a group of one as
        :meth:`weighted_train_step`, a longer one through ``fused_steps``."""
        self._group(batches, self.weighted_train_step, "weighted", self._weighted_update)

    def outer_step(self, val_batch: Batch, train_batch: Batch,
                   val_neg: Optional[torch.Tensor] = None,
                   train_neg: Optional[torch.Tensor] = None, views=None,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One meta update: the hypergradient (lr ``hpo_learning_rate``, 3
        Neumann terms) of ``val_batch``'s unweighted loss through
        ``train_batch``'s weighted loss, clipped to global norm 10, then one
        meta-optimizer step. The val loss draws first, then the train loss,
        each once. Returns the hypergradient before the clip."""
        params = dict(self.rec.module.named_parameters())
        with self._mesh_plans(), plain_attention(), _cudnn_off():
            hgrads = hypergradient(
                lambda p, m: self._weighted_loss(train_batch, m, neg_id=train_neg, views=views,
                                                 noise=noise),
                lambda p: self.rec.training_loss(val_batch, self.generator, neg_id=val_neg),
                params, self.meta_params, lr=self.hpo_lr, truncate_iter=_OUTER_TRUNCATE_ITER,
                axis=self.data_axis)
        clipped = clip_by_global_norm(hgrads, _OUTER_CLIP_NORM)
        for name, p in self.meta_params.items():
            p.grad = clipped[name].detach()
        self.meta_optimizer.step()
        self.meta_optimizer.zero_grad(set_to_none=True)
        return hgrads

    @torch.no_grad()
    def weight_stats(self, batch: Batch,
                     noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The learned weights on a probe batch (train mode, as the weighted
        step sees them), over the real positions of non-pattern rows: mean,
        std, the shares above 0.9 and below 0.1, and the clipped τ. Under
        data parallelism the weights and the mask are gathered over
        ``data`` first, so the statistics are the global batch's."""
        with self._mesh_plans():
            loss_ps, query = self.rec.training_loss(batch, self.generator, reduce=False,
                                                    return_query=True)
            weight, tau = self._weights(query, self.meta_params, noise)
        if weight.dim() > loss_ps.dim():
            weight = weight[..., 0]
        mask = batch["item_id"] != 0
        mask = mask & (batch["user_id"] != 0).reshape((-1,) + (1,) * (mask.dim() - 1))
        if mask.dim() > weight.dim():
            weight = weight[..., None].expand(mask.shape)
        if self.data_axis is not None:
            weight = all_gather(weight, self.data_axis, dim=0)
            mask = all_gather(mask, self.data_axis, dim=0)
        w = weight[mask]
        return {"weight_mean": w.mean(), "weight_std": w.std(correction=0),
                "weight_frac_high": (w > 0.9).float().mean(),
                "weight_frac_low": (w < 0.1).float().mean(), "tau": tau}

    # --------------------------------------------------------------- epoch loop
    def _maybe_outer_step(self, meta_loader, warm: bool) -> None:
        """The outer step, when the step counter sits on an ``interval``
        boundary after warm-up (reference ``model/metamodel.py:104-109``)."""
        if warm or self.step_counter % self.interval != 0:
            return
        val_b = self.device_batch(meta_loader.sample_batch(), is_train=True)
        train_b = self.device_batch(meta_loader.sample_batch(), is_train=True)
        self.outer_step(val_b, train_b)

    def training_epoch(self, nepoch: int) -> float:
        """One epoch in groups of up to ``train.steps_per_dispatch``
        batches, each followed by the outer step when the step counter
        reaches an ``interval`` boundary; outside warm-up no group crosses
        one (JAX's ``take = min(spd, interval − counter % interval)``)."""
        if self.rec is None:
            raise RuntimeError("call init_state() first")
        self.rec.module.train()
        meta_loader = self.train_data.get_loader(seed=nepoch + _META_LOADER_SEED)
        warm = nepoch <= self.warmup_epoch
        self._loss_sum.zero_()
        n_steps = 0
        batches = iter(self.train_data.get_loader(seed=nepoch))
        while True:
            take = self.steps_per_dispatch
            if not warm:
                take = min(take, self.interval - self.step_counter % self.interval)
            group = list(itertools.islice(batches, take))
            if not group:
                break
            if warm:
                self.train_group(group)
            else:
                self.weighted_group(group)
            n_steps += len(group)
            self.step_counter += len(group)
            self._maybe_outer_step(meta_loader, warm)
        if not warm:
            probe = self.device_batch(meta_loader.sample_batch(), is_train=True)
            self.logged_metrics.update(
                {k: float(v) for k, v in self.weight_stats(probe).items()})
        return float(self._loss_sum) / max(n_steps, 1)
