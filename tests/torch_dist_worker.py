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


def run_ranks(fn, world: int, tmp_path, *args):
    """``fn(rank, *args)`` on ``world`` gloo ranks of the CPU, with the
    store under ``tmp_path``; the results in rank order."""
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{world}_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    return launch.run_ranks(fn, world, store, *args, timeout_s=TIMEOUT_S)


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
    from dr4sr_tpu_torch.parallel.collectives import all_reduce_sum, gather_seq, split_seq

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
    return (s.detach().numpy(), x.grad.numpy(), full.detach().numpy(), g.grad.numpy(),
            part.detach().numpy(), r.grad.numpy())


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
