"""Rank workers for the port's distributed CPU tests (torch only, no JAX).

:func:`run_ranks` starts ``world`` processes (``parallel.launch.run_ranks``)
that join one gloo process group through a ``FileStore`` under the test's
``tmp_path`` (so xdist workers never share a port), run one module-level
function of this file each, and send back its result. The group, every
collective and every join has a timeout, so a hung collective fails the
test instead of eating the run; a rank that raises fails it with the
rank's traceback.

The functions below build what they compare from arguments the test
passes (numpy arrays, configs, paths), so the JAX side can run in the
pytest process from the same inputs.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch
import torch.distributed as dist

from dr4sr_tpu_torch.parallel import launch

TIMEOUT_S = 120


def run_ranks(fn, world: int, tmp_path, *args, timeout_s: float = TIMEOUT_S):
    """``fn(rank, *args)`` on ``world`` gloo ranks of the CPU, with the
    store under ``tmp_path``; the results in rank order. ``timeout_s``
    bounds every collective and the wait for the ranks' results (a spawn
    that runs several jobs takes ``TIMEOUT_S`` for each)."""
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{world}_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    return launch.run_ranks(fn, world, store, *args, timeout_s=timeout_s)


def _plan(data, model, shard_embedding=False):
    from dr4sr_tpu_torch.parallel.mesh import MeshPlan, create_mesh

    return MeshPlan(mesh=create_mesh(data=data, model=model, device_type="cpu"),
                    shard_embedding=shard_embedding)


# ----------------------------------------------------------------- the ring


def ring(rank, n, q, k, v, pad, causal, do):
    """The ring over an n-rank model axis on full inputs: (o, dq, dk, dv,
    counter snapshot of the forward, of the backward)."""
    from dr4sr_tpu_torch.ops.ring_attention import ring_attention
    from dr4sr_tpu_torch.parallel.collectives import COUNTER

    plan = _plan(1, n)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    COUNTER.reset()
    o = ring_attention(q, k, v, torch.tensor(pad), causal, axis=plan.axis("model"))
    fwd = COUNTER.snapshot()
    COUNTER.reset()
    o.backward(torch.tensor(do))
    bwd = COUNTER.snapshot()
    return o.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy(), fwd, bwd


def ring_fault_last_rotation(rank, n, q, k, v, pad, causal, do):
    """:func:`ring` with the backward's last send (dK, dV home) left out."""
    from dr4sr_tpu_torch.ops import ring_attention as ra

    real = ra.ring_exchange

    def skip_last(tensors, axis):
        if len(tensors) == 2:  # the backward's last send: dK and dV
            return [t.clone() for t in tensors]
        return real(tensors, axis)

    ra.ring_exchange = skip_last
    try:
        return ring(rank, n, q, k, v, pad, causal, do)
    finally:
        ra.ring_exchange = real


# --------------------------------------------------------------- collectives


def collectives(rank):
    """Each differentiable collective's forward and backward on 2 ranks."""
    from dr4sr_tpu_torch.parallel.collectives import (
        all_reduce_sum,
        gather_rows,
        gather_seq,
        split_seq,
    )

    axis = _plan(1, 2).axis("model")
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    s = all_reduce_sum(x, axis)
    s.backward(torch.full((2, 3), 2.0))
    g = torch.arange(4.0).reshape(1, 4) + 10 * rank
    g.requires_grad_(True)
    full = gather_seq(g, axis, dim=1)
    full.backward(torch.arange(8.0).reshape(1, 8))
    r = torch.arange(8.0).reshape(1, 8).requires_grad_(True)
    part = split_seq(r, axis, dim=1)
    part.backward(torch.full((1, 4), float(rank + 1)))
    h = (torch.arange(4.0) + 10 * rank).reshape(1, 4).requires_grad_(True)
    rows = gather_rows(h, axis, dim=0)
    rows.backward((rank + 1) * torch.arange(8.0).reshape(2, 4))
    return (s.detach().numpy(), x.grad.numpy(), full.detach().numpy(), g.grad.numpy(),
            part.detach().numpy(), r.grad.numpy(), rows.detach().numpy(), h.grad.numpy())


# ------------------------------------------------------------------ training


def _trainer(cfg, root, plan, params):
    from dr4sr_tpu_torch.data.dataset import prepare_datasets
    from dr4sr_tpu_torch.train.trainer import Trainer

    tr = Trainer(copy.deepcopy(cfg), prepare_datasets(copy.deepcopy(cfg), root=root),
                 device="cpu", mesh_plan=plan)
    tr.init_state(seed=7)
    if params is not None:
        tr.set_params({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    return tr


def train_steps(rank, cfg, root, data, model, shard_embedding, batches, negs, params,
                eval_domain=None):
    """Adam steps of a ``Trainer`` over a data × model mesh on the given
    global host batches and negatives: (losses, full params, per-step
    collective counters, eval metrics or None, table rows on this rank,
    the replicated params of this rank for the bitwise check)."""
    from dr4sr_tpu_torch.parallel.collectives import COUNTER

    plan = _plan(data, model, shard_embedding) if data * model > 1 else None
    tr = _trainer(cfg, root, plan, params)
    axis = tr.data_axis
    losses, counters = [], []
    for batch, neg in zip(batches, negs):
        neg = torch.from_numpy(np.array(neg))
        if axis is not None:
            neg = axis.chunk(neg, 0)
        dbatch = tr.device_batch(batch, is_train=True)
        COUNTER.reset()
        losses.append(float(tr.train_step(dbatch, neg_id=neg)))
        counters.append(COUNTER.snapshot())
    metrics = None
    if eval_domain is not None:
        metrics = tr._eval_epoch(tr.val_data, eval_domain)
    full = {k: v.numpy().copy() for k, v in tr.full_state_dict().items()}
    local = {k: v.detach().numpy().copy() for k, v in tr.rec.module.state_dict().items()}
    return losses, full, counters, metrics, tr.rec.module.item_embedding.weight.shape[0], local


def _as_port(views):
    """JAX's views as the port takes them: (seq, seqlen) pairs of int64 tensors."""
    return views and [tuple(torch.from_numpy(np.array(v)).long() for v in pair)
                      for pair in views]


def _rank_rows(x, axis):
    """This rank's rows of a global draw: the views' (seq, seqlen) pairs and
    the augmentation draws' ``start``/``u`` are cut along the batch; a bare
    tensor (a draw over the graph's edges or the catalog) is every rank's."""
    if axis is None or x is None or torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        return {k: axis.chunk(v, 0) if torch.is_tensor(v) else v for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(axis.chunk(v, 0) for v in x)
    return [_rank_rows(v, axis) for v in x]


def zoo_steps(rank, cfg, root, data, model, shard_embedding, ref, steps=3):
    """``steps`` Adam steps of a ``Trainer`` over a data × model mesh on
    ``ref``'s global host batch and draws (``torch_dist_parity.jax_steps``),
    from its initial weights and with its per-epoch state. A model with
    ``refresh_state`` first refreshes its own state of epoch 0 (returned as
    ``refreshed``; ``ref``'s is then put in its place). Returns a dict:
    losses, full and local params, each step's collectives, the table's
    rows on this rank."""
    from dr4sr_tpu_torch.parallel.collectives import COUNTER

    plan = _plan(data, model, shard_embedding) if data * model > 1 else None
    tr = _trainer(cfg, root, plan, ref["init"])
    refreshed = None
    if ref["extras"]:
        tr.refresh_state(0)
        refreshed = {k: tr.batch_extras[k].numpy().copy() for k in ref["extras"]}
        tr.batch_extras.update({k: torch.from_numpy(np.array(v)).to(tr.batch_extras[k].dtype)
                                for k, v in ref["extras"].items()})
    axis = tr.data_axis
    neg = torch.from_numpy(np.array(ref["neg"]))
    neg = neg if axis is None else axis.chunk(neg, 0)
    views = _rank_rows(_as_port(ref["views"]), axis)
    aux = _rank_rows(ref["aux"], axis)
    dbatch = tr.device_batch(ref["batch"], is_train=True)
    losses, counters = [], []
    for _ in range(steps):
        COUNTER.reset()
        losses.append(float(tr.train_step(dbatch, neg_id=neg, views=views, aux_draws=aux)))
        counters.append(COUNTER.snapshot())
    return {"losses": losses, "counters": counters, "refreshed": refreshed,
            "full": {k: v.numpy().copy() for k, v in tr.full_state_dict().items()},
            "local": {k: v.detach().numpy().copy() for k, v in tr.rec.module.state_dict().items()},
            "rows": tr.rec.module.item_embedding.weight.shape[0]}


def _views_gather_seq():
    """Fault: the InfoNCE's views gathered with ``gather_seq``'s backward
    (the rank's own chunk of the cotangent) in place of ``gather_rows``'."""
    from dr4sr_tpu_torch.modules import losses
    from dr4sr_tpu_torch.parallel.collectives import gather_seq

    real = losses.gather_rows
    losses.gather_rows = lambda x, axis, dim=0: gather_seq(x, axis, dim)
    return lambda: setattr(losses, "gather_rows", real)


FAULTS = {"gather_seq": _views_gather_seq}


def zoo_runs(rank, jobs):
    """:func:`zoo_steps` for each of ``jobs``, ``(fault, arguments after the
    rank)`` with ``fault`` None or a key of :data:`FAULTS`, in one spawn of
    the ranks."""
    out = []
    for fault, args in jobs:
        undo = FAULTS[fault]() if fault else (lambda: None)
        try:
            out.append(zoo_steps(rank, *args))
        finally:
            undo()
    return out


# ------------------------------------------------------------------- DR4SR+

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs")


def _hvps_unreduced():
    """Fault: the outer step's Hessian-vector products left out of the
    all-reduce over ``data`` (``hypergradient`` sums 2 + 3 trees an outer
    step, in the order ∂L_val/∂W, the 3 products, ∂(g·p)/∂φ)."""
    from dr4sr_tpu_torch.meta import hypergrad

    real, calls = hypergrad._sum_over, []

    def skip_products(grads, axis):
        calls.append(None)
        return grads if len(calls) % 5 in (2, 3, 4) else real(grads, axis)

    hypergrad._sum_over = skip_products
    return lambda: setattr(hypergrad, "_sum_over", real)


def _identity_double_backward():
    """Fault: ``all_reduce_sum``'s backward a plain identity, whose own
    derivative is the identity too, not the sum over the axis."""
    from dr4sr_tpu_torch.parallel import collectives

    real = collectives._AllReduceSum.backward
    collectives._AllReduceSum.backward = staticmethod(lambda ctx, grad: (grad, None))
    return lambda: setattr(collectives._AllReduceSum, "backward", real)


META_FAULTS = {"hvps_unreduced": _hvps_unreduced,
               "identity_double_backward": _identity_double_backward}


def meta_steps(rank, cfg, root, data, model, shard_embedding, ref, fault=None):
    """A ``MetaTrainer`` over a data × model mesh from ``ref``'s sub-model
    and meta weights: a weighted step on ``ref["tb"]``, an outer step on
    ``ref["vb"]`` and ``ref["ob"]``, a second weighted step, each with
    ``ref``'s global draws cut to this rank's rows. Returns each step's loss,
    collectives and the weights after it, and the hypergradient."""
    from dr4sr_tpu_torch.data.dataset import prepare_datasets
    from dr4sr_tpu_torch.parallel.collectives import COUNTER
    from dr4sr_tpu_torch.train.meta_trainer import MetaTrainer

    undo = META_FAULTS[fault]() if fault else (lambda: None)
    try:
        plan = _plan(data, model, shard_embedding) if data * model > 1 else None
        tr = MetaTrainer(copy.deepcopy(cfg), prepare_datasets(copy.deepcopy(cfg), root=root),
                         device="cpu", config_dir=CONFIG_DIR, mesh_plan=plan)
        tr.init_state(seed=0)
        tr.set_params({k: torch.from_numpy(np.asarray(v)) for k, v in ref["init"].items()})
        mlp, tau = ref["meta_init"]
        tr.load_meta({k: torch.from_numpy(np.asarray(v)) for k, v in mlp.items()}, tau)

        def rows(x):
            x = torch.from_numpy(np.array(x))
            return x if tr.data_axis is None else tr.data_axis.chunk(x, 0)

        def state():
            return ({k: v.numpy().copy() for k, v in tr.full_state_dict().items()},
                    {k: v.detach().numpy().copy() for k, v in tr.meta_params.items()})

        out = {}
        tb = tr.device_batch(ref["tb"], is_train=True)
        for step, draws in (("w1", ref["w1"]), ("outer", ref["outer"]), ("w2", ref["w2"])):
            COUNTER.reset()
            if step == "outer":
                val_neg, train_neg, noise = (rows(x) for x in draws)
                h = tr.outer_step(tr.device_batch(ref["vb"], is_train=True),
                                  tr.device_batch(ref["ob"], is_train=True), val_neg=val_neg,
                                  train_neg=train_neg, noise=noise)
                out["hypergrad"] = {k: v.detach().numpy().copy() for k, v in h.items()}
            else:
                neg, noise = (rows(x) for x in draws)
                out[f"{step}_loss"] = float(tr.weighted_train_step(tb, neg_id=neg, noise=noise))
            out[f"{step}_collectives"] = COUNTER.snapshot()
            out[f"{step}_params"], out[f"{step}_meta"] = state()
        out["local"] = {k: v.detach().numpy().copy() for k, v in tr.rec.module.state_dict().items()}
        return out
    finally:
        undo()


def meta_runs(rank, jobs):
    """:func:`meta_steps` for each of ``jobs`` (its arguments after the rank)."""
    return [meta_steps(rank, *job) for job in jobs]


def _fused_trainer(cfg, root, plan, spd, dropout, meta):
    """A ``Trainer`` (seed 7) or ``MetaTrainer`` (seed 0) at
    ``steps_per_dispatch`` ``spd`` and ``dropout``; a meta config's
    sub-model takes both through ``_cli_overrides``."""
    from dr4sr_tpu_torch.data.dataset import prepare_datasets
    from dr4sr_tpu_torch.train.meta_trainer import MetaTrainer

    cfg = copy.deepcopy(cfg)
    for section in (cfg, cfg.get("_cli_overrides", {})) if meta else (cfg,):
        section.setdefault("train", {})["steps_per_dispatch"] = spd
        section.setdefault("model", {})["dropout_rate"] = dropout
    if not meta:
        return _trainer(cfg, root, plan, None)
    tr = MetaTrainer(cfg, prepare_datasets(copy.deepcopy(cfg), root=root), device="cpu",
                     config_dir=CONFIG_DIR, mesh_plan=plan)
    tr.init_state(seed=0)
    return tr


def fused_group(rank, cfg, root, data, model, shard_embedding, ref, meta=False, epochs=2):
    """``train.steps_per_dispatch`` on a data × model mesh (one process
    when ``data · model`` is 1):

    * ``n1``, ``n4``: a trainer at N = 1 and one at N = 4 take ``epochs``
      epochs (dropout 0.1, their own draws): the epoch losses, the local
      weights (and the meta parameters);
    * ``group``: a trainer at N = 4 from ``ref``'s initial weights (and
      meta parameters) takes ``ref``'s batches as one group through
      ``fused_steps``, each step with ``ref``'s global draws cut to this
      rank's rows: the losses, the full and local weights, the group's
      collectives."""
    from dr4sr_tpu_torch.parallel.collectives import COUNTER

    plan = _plan(data, model, shard_embedding) if data * model > 1 else None
    out = {}
    for spd in (1, 4):
        tr = _fused_trainer(cfg, root, plan, spd, 0.1, meta)
        losses = [tr.training_epoch(e) for e in range(epochs)]
        out[f"n{spd}"] = {
            "losses": losses, "step": tr.step,
            "local": {k: v.detach().numpy().copy() for k, v in tr.rec.module.state_dict().items()},
            "meta": ({k: v.detach().numpy().copy() for k, v in tr.meta_params.items()}
                     if meta else None)}
    tr = _fused_trainer(cfg, root, plan, 4, 0.0, meta)
    tr.set_params({k: torch.from_numpy(np.asarray(v)) for k, v in ref["init"].items()})
    draws = iter(_rank_rows([tuple(torch.from_numpy(np.array(x)) for x in step)
                             for step in ref["draws"]], tr.data_axis))
    if meta:
        mlp, tau = ref["meta_init"]
        tr.load_meta({k: torch.from_numpy(np.asarray(v)) for k, v in mlp.items()}, tau)

        def update(batch):
            neg, noise = next(draws)
            return tr._weighted_update(batch, neg_id=neg, noise=noise)
    else:
        def update(batch):
            return tr._update(batch, neg_id=next(draws)[0])

    COUNTER.reset()
    losses = tr.fused_steps(ref["batches"], "weighted" if meta else "train", update)
    out["group"] = {
        "losses": losses.tolist(), "collectives": COUNTER.snapshot(),
        "full": {k: v.numpy().copy() for k, v in tr.full_state_dict().items()},
        "local": {k: v.detach().numpy().copy() for k, v in tr.rec.module.state_dict().items()}}
    return out


def fused_groups(rank, jobs):
    """:func:`fused_group` for each of ``jobs`` (its arguments after the rank)."""
    return [fused_group(rank, *args, **kwargs) for args, kwargs in jobs]


def cli(rank, workdir, argv):
    """``python -m dr4sr_tpu_torch.run`` with ``argv`` on this rank (the
    process group joined already, as torchrun's would be), run from
    ``workdir``: the test metrics it returns, and the trainer it made."""
    from dr4sr_tpu_torch import quickstart, run

    made = []
    make = quickstart.make_trainer
    quickstart.make_trainer = lambda *a, **k: made.append(make(*a, **k)) or made[-1]
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        metrics = run.main(argv)
    finally:
        os.chdir(cwd)
        quickstart.make_trainer = make
    tr = made[0]
    return metrics, tr.steps_per_dispatch, tr.world_size, tr.step, \
        {k: v.detach().numpy().copy() for k, v in tr.rec.module.state_dict().items()}


def train_epochs(rank, cfg, root, data, model, shard_embedding, epochs):
    """``training_epoch`` for ``epochs`` epochs and one validation pass."""
    plan = _plan(data, model, shard_embedding) if data * model > 1 else None
    tr = _trainer(cfg, root, plan, None)
    losses = [tr.training_epoch(e) for e in range(epochs)]
    return losses, tr.validate()


def fit_and_reload(rank, cfg, root, data, model, workdir):
    """``fit`` with an EP table and a resumable state every epoch: (whether
    this rank wrote its best checkpoint, the checkpoint's params as rank 0
    reads them back, the validation metrics of the best params, whether a
    fresh trainer on the same mesh restores the state's weights and Adam
    moments as they were)."""
    from dr4sr_tpu_torch.train.checkpoint import load_checkpoint

    cfg = copy.deepcopy(cfg)
    cfg["eval"]["save_path"] = workdir
    cfg["train"]["checkpoint_every_epochs"] = 1
    plan = _plan(data, model, True)
    tr = _trainer(cfg, root, plan, None)
    tr.fit()
    written = os.path.exists(tr.callback.checkpoint_path)
    val = tr._eval_epoch(tr.val_data, tr.domain_name_list[0], tr._rec_with(tr.best_params))
    dist.barrier()
    params = None
    if rank == 0:
        params = {k: v.numpy() for k, v in load_checkpoint(tr.callback.checkpoint_path)[0].items()}
    resumed = _trainer(cfg, root, plan, None)
    resumed.init_state(seed=99)
    assert resumed.restore_train_state() == 1
    restored = all(torch.equal(v, resumed.rec.module.state_dict()[k])
                   for k, v in tr.rec.module.state_dict().items())
    for (_, a), (_, b) in zip(sorted(tr.optimizer.state_dict()["state"].items()),
                              sorted(resumed.optimizer.state_dict()["state"].items())):
        restored &= all(torch.equal(a[k], b[k]) for k in a)
    return written, params, val, restored


# -------------------------------------------------------------------- decode


def decode(rank, data, gen_state, gen_kwargs, seqs, k, batch_size, max_len, gamma, beam):
    """``decode_dataset`` over a data mesh of ``data`` ranks."""
    from dr4sr_tpu_torch.regen.decode import decode_dataset
    from dr4sr_tpu_torch.regen.generator import Generator

    gen = Generator(**gen_kwargs)
    gen.load_state_dict({k_: torch.from_numpy(v) for k_, v in gen_state.items()})
    return decode_dataset(gen, seqs, k, batch_size=batch_size, max_len=max_len, gamma=gamma,
                          seed=3, beam_width=beam, mesh_plan=_plan(data, 1))


# ---------------------------------------------------------------------- eval


def sharded_topk(rank, s, query, table, keep, hist, k):
    """``sharded_masked_topk`` of this rank's rows of ``table`` over s ranks."""
    from dr4sr_tpu_torch.ops.topk import sharded_masked_topk

    axis = _plan(1, s).axis("model")
    rows = table.shape[0] // s
    sl = slice(axis.index * rows, (axis.index + 1) * rows)
    scores, ids = sharded_masked_topk(torch.from_numpy(query), torch.from_numpy(table[sl]), k,
                                      axis, torch.from_numpy(keep[sl]), torch.from_numpy(hist))
    return scores.numpy(), ids.numpy()
