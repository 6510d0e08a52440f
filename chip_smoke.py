#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dr4sr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of the repository

Phases, in order; any failure raises and the script exits nonzero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the package, from ``dr4sr_tpu_torch/ops/csrc``;
   the forward's machine code (``cuobjdump -sass``) must hold tensor-core
   ``HMMA`` instructions in every instantiation, bf16 and f32;
3. kernels: the attention forward against its plain PyTorch version on the
   card, at the serving (and training) shape, the eval batch and a stress
   shape, with and without a key-padding mask (one fully masked row per
   batch), with its device time per call beside the plain version's, one
   PyTorch library call's and the least time the card could take;
3b. the attention backward kernels likewise, against
   ``flash_attention_bwd_reference``, and the whole ``FlashAttention`` path
   against autograd through ``mha_reference``;
4. serve: ``Recommender(device="cuda")`` answers three requests of 1,000
   histories on SASRec at the amazon-toys width (random weights from seed 0),
   through the kernels, and agrees with the same weights on the CPU route;
   then times one-batch requests, and profiles one more pass with
   ``torch.profiler`` (device time by kernel, host time by op, busy share);
5. train: ``Trainer(device="cuda").fit()`` for 3 epochs, then ``evaluate()``,
   on SASRec at the amazon-toys width over a synthetic dataset of
   amazon-toys' size (19,412 users, 11,925 items), through both kernels:
   launch counts, a falling loss, validation recall@20 above 5x random; the
   first step's gradients and 3 Adam steps' losses against the CPU route
   from the same weights and negatives; a few bf16 steps; timed steps; and
   a profile of a few steps.

It prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX. Kernel times
are device time per call (:func:`device_ms`).

    python3 chip_smoke.py --controls

runs only the card-vs-CPU gradient check of phase 5, once with each of a few
deliberate faults patched into the backward route, and prints whether the
check caught each (a ``control {...}`` line per fault).
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import markov_sequences, write_synthetic_dataset
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.ops import _build, attention
from dr4sr_tpu_torch.ops.attention import (
    FlashAttention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    mha_reference,
)
from dr4sr_tpu_torch.serve import Recommender
from dr4sr_tpu_torch.train.trainer import Trainer

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and dense
# tensor-core FLOP/s. A bound is the least time the card could take for the
# work, whatever route a kernel takes, so f32 products count at the faster
# of the card's two f32-accurate routes: 3xTF32 on tensor cores (495
# TFLOP/s of TF32, three products each: 165 TFLOP/s), not FMA on CUDA cores
# (67 TFLOP/s).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # as tests/test_attention.py
ATOL_BWD = {torch.float32: 3e-4, torch.bfloat16: 8e-2}  # as tests/test_attention.py
PATH_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-7}  # one bf16 step, relative

# amazon-toys SASRec: configs/{amazon-toys,basemodel,sasrec}.yaml, written out
NUM_ITEMS = 11925
CONFIG = {
    "data": {"dataset": "amazon-toys", "domain_name_list": ["toy"], "max_seq_len": 50},
    "model": {"model": "SASRec", "embed_dim": 64, "head_num": 2, "layer_num": 2,
              "hidden_size": 128, "dropout_rate": 0.5, "activation": "gelu",
              "layer_norm_eps": 1e-12},
}
BATCH = 256
TOPK = 20
SERVE_PASSES = 9  # 9 x 12 one-batch requests: p90 has 10 samples above it

# training at the amazon-toys width: configs/{amazon-toys,basemodel,sasrec}.yaml
# written out, on a synthetic dataset of amazon-toys' size (19,412 users)
NUM_USERS = 19412
TRAIN_CONFIG = {
    "data": {"dataset": "amazon-toys", "domain_name_list": ["toy"], "max_seq_len": 50,
             "dataset_class": "general", "train_file": ""},
    "model": {**CONFIG["model"], "loss_fn": "bce"},
    "train": {"batch_size": BATCH, "epochs": 3, "optimizer": "adam", "learning_rate": 1e-3,
              "weight_decay": 0.0, "num_neg": 1, "seed": 2023, "early_stop_mode": "max",
              "early_stop_patience": 20, "precision": "fp32"},
    "eval": {"batch_size": 2048, "cutoff": [20, 10], "val_metrics": ["ndcg", "recall"],
             "test_metrics": ["ndcg", "recall"], "topk": 100},
}
# card vs CPU from the same weights and negatives, dropout 0, TF32 off: f32
# sums run in another order (cuBLAS, the kernels, LayerNorm's reductions).
# Each parameter's error is taken relative to its largest gradient.
GRAD_RTOL = 1e-5
LOSS_ATOL = 1e-5

# (name, B, H, Lq, Lk, Dh, causal, dtype): the serving shape first; every
# head dim the kernel is built for, ragged tiles, and Lq != Lk
ATTENTION_CASES = [
    ("serve_f32", 256, 2, 50, 50, 32, True, torch.float32),
    ("serve_bf16", 256, 2, 50, 50, 32, True, torch.bfloat16),
    ("stress_f32", 128, 4, 512, 512, 64, True, torch.float32),
    ("stress_bf16", 128, 4, 512, 512, 64, True, torch.bfloat16),
    ("cross_f32", 64, 2, 20, 50, 32, False, torch.float32),
    ("dh16_bf16", 16, 2, 100, 100, 16, True, torch.bfloat16),
    ("dh128_f32", 16, 2, 130, 130, 128, True, torch.float32),
]
# forward only: the eval batch of the train path (evaluation takes no gradient)
FWD_ONLY_CASES = [("eval_f32", 2048, 2, 50, 50, 32, True, torch.float32)]


def log(msg: str) -> None:
    print(msg, flush=True)


TIMING = "device time per call: torch.profiler's kernel time over 50 calls, summed, / 50"


def device_ms(fn, calls: int = 50) -> float:
    """Device time per call of ``fn``: the duration of every device activity
    that ``calls`` calls launch, as ``torch.profiler`` reads it, summed and
    divided by ``calls``, after one warm-up call. The host's enqueue time and
    the gaps between launches are not in it (a CUDA-event window over a few
    calls at small shapes measures them instead)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in _device_rows(prof.key_averages()))
    if not us > 0:
        raise AssertionError("the profiler saw no device time")
    return us / calls / 1e3


def _unmasked_pairs(pad, lq, lk, causal):
    """(batch, query, key) triples that this mask leaves unmasked."""
    pairs = (~pad)[:, None, :].expand(pad.shape[0], lq, lk)
    if causal:
        pairs = pairs & torch.ones(lq, lk, dtype=torch.bool, device=pad.device).tril()
    return int(pairs.sum())


def _bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_bound_ms(q, k, v, pad, causal):
    """The least time for this call: each input read once and the output
    written once at the HBM rate, or the products that this data needs
    (q·kᵀ and p·v over unmasked pairs) at the dtype's peak."""
    b, h, lq, dh = q.shape
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() + pad.numel()
    flops = 4 * dh * h * _unmasked_pairs(pad, lq, k.shape[2], causal)
    return _bound(nbytes, flops, q.dtype)


def attention_bwd_bound_ms(q, k, pad, causal):
    """The backward's least time: q, k, v, o, dO, the row statistics and the
    mask read once and dq, dk, dv written once, or 10·Dh FLOP per unmasked
    pair and head for the five products (q·kᵀ, dO·vᵀ, pᵀ·dO, ds·k, dsᵀ·q)."""
    b, h, lq, dh = q.shape
    es = q.element_size()
    nbytes = es * 4 * (q.numel() + k.numel()) + 4 * b * h * lq + pad.numel()
    flops = 10 * dh * h * _unmasked_pairs(pad, lq, k.shape[2], causal)
    return _bound(nbytes, flops, q.dtype)


def check_attention(seed, name, b, h, lq, lk, dh, causal, dtype):
    """The forward kernel against ``mha_reference``, with a key-padding mask
    (one fully masked row, which must be exactly 0) and without; then its
    device time beside the plain version's and SDPA's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, dh, generator=gen, device="cuda").to(dtype)
               for n in (lq, lk, lk))
    seqlen = torch.randint(0, lk + 1, (b,), generator=gen, device="cuda")
    seqlen[0] = 0  # one fully masked row in every batch
    pad = torch.arange(lk, device="cuda")[None, :] >= seqlen[:, None]
    with torch.no_grad():
        out = flash_attention_fwd(q, k, v, pad, causal)[0]
        out_nomask = flash_attention_fwd(q, k, v, None, causal)[0]
        torch.cuda.synchronize()
        ref = mha_reference(q, k, v, pad, causal)
        ref_nomask = mha_reference(q, k, v, None, causal)
    if not (torch.isfinite(out).all() and torch.isfinite(out_nomask).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if (out[0] != 0).any():
        raise AssertionError(f"{name}: the fully masked row is not 0")
    err = max((out.float() - ref.float()).abs().max().item(),
              (out_nomask.float() - ref_nomask.float()).abs().max().item())
    if err > ATOL[dtype]:
        raise AssertionError(f"{name}: max |kernel - plain| {err} > {ATOL[dtype]}")
    # SDPA gives NaN on fully masked rows, so its yardstick inputs have none
    lib_len = torch.randint(1, lk + 1, (b,), generator=gen, device="cuda")
    attend = (torch.arange(lk, device="cuda")[None, :] < lib_len[:, None])[:, None, None, :]
    if causal:
        attend = attend & torch.ones(lq, lk, dtype=torch.bool, device="cuda").tril()
    with torch.no_grad():
        ms = device_ms(lambda: flash_attention_fwd(q, k, v, pad, causal))
        plain_ms = device_ms(lambda: mha_reference(q, k, v, pad, causal))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attend))
    bound_ms, bound_by = attention_bound_ms(q, k, v, pad, causal)
    case = {"case": name, "shape": [b, h, lq, lk, dh], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "atol": ATOL[dtype],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "timing": TIMING}
    log(f"kernel case {json.dumps(case)}")
    return case


def _max_err(got, want):
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def check_attention_bwd(seed, name, b, h, lq, lk, dh, causal, dtype):
    """The backward kernels against ``flash_attention_bwd_reference`` on the
    same o, with a key-padding mask (one fully masked row) and without; the
    whole ``FlashAttention`` path against autograd through ``mha_reference``."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
    q, k, v = (torch.randn(b, h, n, dh, generator=gen, device="cuda").to(dtype)
               for n in (lq, lk, lk))
    do = torch.randn(b, h, lq, dh, generator=gen, device="cuda").to(dtype)
    seqlen = torch.randint(0, lk + 1, (b,), generator=gen, device="cuda")
    seqlen[0] = 0  # one fully masked row in every batch
    pad = torch.arange(lk, device="cuda")[None, :] >= seqlen[:, None]
    err = 0.0
    with torch.no_grad():
        for mask in (pad, None):
            o, lse = flash_attention_fwd(q, k, v, mask, causal, want_lse=True)
            got = flash_attention_bwd(q, k, v, o, do, lse, mask, causal)
            torch.cuda.synchronize()
            want = flash_attention_bwd_reference(q, k, v, o, do, mask, causal)
            if not all(torch.isfinite(g).all() for g in got):
                raise AssertionError(f"{name}: non-finite backward output")
            if mask is pad and any((g[0] != 0).any() for g in got):
                raise AssertionError(f"{name}: the fully masked batch row has gradients")
            err = max(err, _max_err(got, want))
    if err > ATOL_BWD[dtype]:
        raise AssertionError(f"{name}: max |bwd kernel - plain| {err} > {ATOL_BWD[dtype]}")

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(FlashAttention.apply(*leaves, pad, causal), leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(mha_reference(*ref_leaves, pad, causal), ref_leaves, do)
    # autograd of mha_reference rounds neither p nor ds to bf16, so in bf16
    # the two may differ by one bf16 step of the gradient's own size as well
    rtol = PATH_RTOL[dtype]
    diffs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    path_err = max(d.max().item() for d in diffs)
    # the size of the gradient where the path's error is largest
    i = max(range(len(diffs)), key=lambda i: diffs[i].max().item())
    path_grad_at_err = want[i].flatten()[diffs[i].argmax()].abs().item()
    excess = max((d - rtol * w.float().abs()).max().item() for d, w in zip(diffs, want))
    if excess > ATOL_BWD[dtype]:
        raise AssertionError(f"{name}: FlashAttention grads vs autograd of mha_reference "
                             f"{path_err} > {ATOL_BWD[dtype]} + {rtol}·|grad|")

    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, pad, causal, want_lse=True)
        ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, pad, causal))
        plain_ms = device_ms(lambda: flash_attention_bwd_reference(q, k, v, o, do, pad, causal))
    # SDPA gives NaN on fully masked rows, so its yardstick inputs have none;
    # its graph is built once and only the backward is timed
    lib_len = torch.randint(1, lk + 1, (b,), generator=gen, device="cuda")
    attend = (torch.arange(lk, device="cuda")[None, :] < lib_len[:, None])[:, None, None, :]
    if causal:
        attend = attend & torch.ones(lq, lk, dtype=torch.bool, device="cuda").tril()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=attend)
    library_ms = device_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    del out, leaves
    bound_ms, bound_by = attention_bwd_bound_ms(q, k, pad, causal)
    case = {"case": name, "shape": [b, h, lq, lk, dh], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "path_max_abs_err": path_err, "path_grad_at_err": path_grad_at_err,
            "atol": ATOL_BWD[dtype], "path_rtol": rtol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "timing": TIMING}
    log(f"kernel case bwd {json.dumps(case)}")
    return case


def serve(requests, card):
    """Serve ``requests`` on the card; check the answers; time them."""
    module = SASRec.build(CONFIG, NUM_ITEMS, generator=torch.Generator().manual_seed(0))
    rec = RecModel(CONFIG, module, NUM_ITEMS, 0)
    gpu = Recommender(rec, module.state_dict(), batch_size=BATCH, device="cuda")
    gpu.recommend(requests[0][:BATCH], k=TOPK)  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    answers = [gpu.recommend(r, k=TOPK) for r in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    bwd_launches = flash_attention_bwd.launches

    L = CONFIG["data"]["max_seq_len"]
    batches = sum(-(-len(r) // BATCH) for r in requests)
    want = CONFIG["model"]["layer_num"] * batches
    if launches != want or bwd_launches != 0:
        raise AssertionError(f"serving launched the forward {launches} times (want {want}) "
                             f"and the backward {bwd_launches} times (want 0)")
    for hist, (items, scores) in zip(requests, answers):
        if items.shape != (len(hist), TOPK) or not np.isfinite(scores).all():
            raise AssertionError("bad shape or non-finite scores")
        if (items == 0).any():
            raise AssertionError("PAD recommended")
        for h, row in zip(hist, items):
            if len(set(row.tolist())) != TOPK or set(row.tolist()) & set(h[-L:]):
                raise AssertionError("repeated or already seen item recommended")

    cpu = Recommender(rec, module.state_dict(), batch_size=BATCH, device="cpu")
    tol = 1e-4
    for hist, (items, scores) in zip(requests, answers):
        want_i, want_s = cpu.recommend(hist, k=TOPK)
        err = np.abs(scores - want_s).max()
        if err > tol:
            raise AssertionError(f"card vs CPU scores differ by {err} > {tol}")
        gap = np.abs(np.diff(want_s, axis=1)) > tol
        sep = np.ones(want_s.shape, bool)
        sep[:, 1:] &= gap
        sep[:, :-1] &= gap
        sep[:, -1] = False
        if (items[sep] != want_i[sep]).any():
            raise AssertionError("card vs CPU ranking differs where scores are apart")

    # steady state, uncounted: one-batch requests, each timed to its answer
    flat = [h for r in requests for h in r]
    chunks = [flat[i : i + BATCH] for i in range(0, len(flat), BATCH)]
    lat_ms = []
    for _ in range(SERVE_PASSES):
        for chunk in chunks:
            t0 = time.perf_counter()
            gpu.recommend(chunk, k=TOPK)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
    result = {"histories": len(flat), "batches": batches, "batch_size": BATCH, "k": TOPK,
              "checked_pass_s": wall, "batch_ms_p50": float(np.percentile(lat_ms, 50)),
              "batch_ms_p90": float(np.percentile(lat_ms, 90)), "batch_samples": len(lat_ms),
              "histories_per_s": SERVE_PASSES * len(flat) / (sum(lat_ms) / 1e3),
              "attention_launches": launches, "attention_bwd_launches": bwd_launches,
              "card": card}
    log(f"serve {json.dumps(result)}")
    profile_serve(gpu, requests)
    return launches, bwd_launches


def profile_serve(gpu, requests):
    """One pass under ``torch.profiler``: device time by kernel, host time by
    op, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in requests:
            gpu.recommend(r, k=TOPK)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    log(f"profile: one serving pass, {sum(-(-len(r) // BATCH) for r in requests)} batches")
    _log_profile(prof, wall_us)


def _device_rows(events):
    """The device's own activity: kernels, copies and sets. A user annotation
    (``Optimizer.step#Adam.step``) also has a device row, which spans the
    kernels launched inside it and would count them twice."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _log_profile(prof, wall_us):
    """Device time by kernel (kernel rows only: an op's row repeats the
    device time of its kernels), host time by op, and the busy share."""
    events = prof.key_averages()
    kernels = _device_rows(events)
    device_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile wall_us {wall_us:.1f} device_busy_us {device_us:.1f} "
        f"busy_share {device_us / wall_us:.4f} (profiler on)")
    # the top 12 by device time, and the attention kernels wherever they rank
    for rank, e in enumerate(sorted(kernels, key=lambda e: -e.self_device_time_total), 1):
        if rank <= 12 or "flash_" in e.key:
            log(f"  rank {rank:3d} device_us {e.self_device_time_total:10.1f} "
                f"calls {e.count:6d} {e.key[:90]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"  host_us {e.self_cpu_time_total:10.1f} calls {e.count:6d} {e.key[:90]}")


def _train_cfg(workdir, **train):
    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["eval"]["save_path"] = workdir
    cfg["train"].update(train)
    return cfg


def card_vs_cpu(datasets, workdir):
    """From the same initial weights, with dropout 0 and the same fed
    negatives: the first step's gradients and 3 Adam steps' losses, card
    against CPU. Returns the errors; :func:`check_card_vs_cpu` judges them."""
    cfg = _train_cfg(workdir)
    cfg["model"]["dropout_rate"] = 0.0
    rng = np.random.default_rng(0)
    batches = []
    for batch in datasets[0].get_loader(seed=0):
        batches.append((batch, rng.integers(1, NUM_ITEMS, size=(BATCH, 50, 1))))
        if len(batches) == 3:
            break
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, datasets, workdir=workdir, device=device)
        trainer.init_state()
        losses, grads = [], None
        for batch, neg in batches:
            trainer.optimizer.zero_grad(set_to_none=True)
            loss = trainer.rec.training_loss(trainer.device_batch(batch), None,
                                             neg_id=torch.from_numpy(neg).to(trainer.device))
            loss.backward()
            if grads is None:
                grads = {k: p.grad.detach().cpu() for k, p in trainer.rec.module.named_parameters()}
            trainer.optimizer.step()
            losses.append(loss.item())
        runs[device] = (losses, grads)
    abs_err = {k: (runs["cuda"][1][k] - g).abs().max().item() for k, g in runs["cpu"][1].items()}
    rel_err = {k: abs_err[k] / max(g.abs().max().item(), 1e-30)
               for k, g in runs["cpu"][1].items()}
    worst = max(rel_err, key=rel_err.get)
    return {"grad_max_rel_err": rel_err[worst], "grad_worst_param": worst,
            "grad_worst_param_absmax": runs["cpu"][1][worst].abs().max().item(),
            "grad_max_abs_err": max(abs_err.values()), "grad_rtol": GRAD_RTOL,
            "loss_max_abs_err": max(abs(a - b) for a, b in zip(runs["cuda"][0], runs["cpu"][0])),
            "loss_atol": LOSS_ATOL, "losses_card": runs["cuda"][0], "losses_cpu": runs["cpu"][0]}


def check_card_vs_cpu(parity):
    if not (parity["grad_max_rel_err"] <= GRAD_RTOL and parity["loss_max_abs_err"] <= LOSS_ATOL):
        raise AssertionError(f"card vs CPU: grads {parity['grad_max_rel_err']} of the largest "
                             f"({parity['grad_worst_param']}; rtol {GRAD_RTOL}), "
                             f"losses {parity['loss_max_abs_err']} (atol {LOSS_ATOL})")


def bf16_steps(datasets, workdir, steps=5):
    """A few steps with ``train.precision: bf16`` (autocast): finite losses,
    through the backward kernel, f32 master weights."""
    trainer = Trainer(_train_cfg(workdir, precision="bf16"), datasets, workdir=workdir)
    trainer.init_state()
    flash_attention_bwd.launches = 0
    losses = []
    for batch, _ in zip(trainer.train_data.get_loader(seed=0), range(steps)):
        losses.append(trainer.train_step(trainer.device_batch(batch)).item())
    if not np.isfinite(losses).all() or flash_attention_bwd.launches == 0:
        raise AssertionError(f"bf16 steps: losses {losses}, "
                             f"backward launches {flash_attention_bwd.launches}")
    if any(p.dtype != torch.float32 for p in trainer.rec.module.parameters()):
        raise AssertionError("bf16 steps: master weights are not f32")
    return losses


def train(card):
    """Phase 5: the train path through ``Trainer.fit`` and ``evaluate``, on a
    dataset written to a temporary directory that is removed afterwards."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        return _train(card, workdir)


def _datasets(workdir):
    write_synthetic_dataset(workdir, name="amazon-toys", domain="toy", num_users=NUM_USERS,
                            num_items=NUM_ITEMS, seed=0)
    return prepare_datasets(TRAIN_CONFIG, root=workdir)


def _train(card, workdir):
    t0 = time.perf_counter()
    datasets = _datasets(workdir)
    data_s = time.perf_counter() - t0
    steps_per_epoch = len(datasets[0].get_loader())
    eval_batches = len(datasets[1].get_loader())
    layers = TRAIN_CONFIG["model"]["layer_num"]
    epochs = TRAIN_CONFIG["train"]["epochs"]

    trainer = Trainer(_train_cfg(workdir), datasets, workdir=workdir, device="cuda")
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    val = trainer.fit()
    test = trainer.evaluate()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd_launches = flash_attention_fwd.launches
    bwd_launches = flash_attention_bwd.launches

    steps = epochs * steps_per_epoch
    want_fwd = layers * (steps + (epochs + 1) * eval_batches)  # val every epoch, then test
    want_bwd = layers * steps * 2  # two CUDA kernels per backward: dq, then dk/dv
    if fwd_launches != want_fwd or bwd_launches != want_bwd:
        raise AssertionError(f"launches: forward {fwd_launches} (want {want_fwd}), "
                             f"backward {bwd_launches} (want {want_bwd})")
    with open(f"{trainer.run_dir()}/metrics.jsonl") as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    if not (np.isfinite(losses).all() and losses[-1] < 2 * np.log(2)):
        raise AssertionError(f"the train loss did not fall below 2·ln 2: {losses}")
    random_recall = 20 / (NUM_ITEMS - 1)
    if not val["recall@20"] > 5 * random_recall:
        raise AssertionError(f"validation recall@20 {val['recall@20']} is not above "
                             f"5 x random ({random_recall})")

    parity = card_vs_cpu(datasets, workdir)
    check_card_vs_cpu(parity)
    bf16 = bf16_steps(datasets, workdir)

    # timed steps (uncounted): one epoch, each step from host batch to done
    lat_ms, seqs = [], 0
    for i, batch in enumerate(trainer.train_data.get_loader(seed=epochs)):
        t0 = time.perf_counter()
        trainer.train_step(trainer.device_batch(batch))
        torch.cuda.synchronize()
        if i > 0:  # the first step is the warm-up
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            seqs += int(batch["valid"].sum())
    result = {
        "users": NUM_USERS, "items": NUM_ITEMS, "steps_per_epoch": steps_per_epoch,
        "epochs": epochs, "eval_batches_per_pass": eval_batches, "data_build_s": data_s,
        "fit_and_evaluate_s": fit_s, "epoch_train_s": trainer.training_time / epochs,
        "epoch_eval_s": trainer.inference_time / epochs,
        "steps_per_s": len(lat_ms) / (sum(lat_ms) / 1e3),
        "sequences_per_s": seqs / (sum(lat_ms) / 1e3),
        "step_ms_p50": float(np.percentile(lat_ms, 50)),
        "step_ms_p90": float(np.percentile(lat_ms, 90)), "timed_steps": len(lat_ms),
        "train_losses": losses, "val": val, "test": test,
        "attention_fwd_launches": fwd_launches, "attention_bwd_launches": bwd_launches,
        "card_vs_cpu": parity, "bf16_losses": bf16, "card": card,
    }
    log(f"train {json.dumps(result)}")
    profile_train(trainer)
    return fwd_launches, bwd_launches


def profile_train(trainer, steps=10):
    """``steps`` train steps under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    batches = [b for b, _ in zip(trainer.train_data.get_loader(seed=0), range(steps))]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            trainer.train_step(trainer.device_batch(batch))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    log(f"profile: {steps} train steps")
    _log_profile(prof, wall_us)


# deliberate faults in the backward route, each of which the card-vs-CPU
# check should catch: the key-padding mask dropped, the causal mask dropped,
# and the row log-sum-exp off by 1e-3 (every p scaled by e^-0.001)
FAULTS = {
    "no_key_padding_mask": lambda bwd: (
        lambda q, k, v, o, do, lse, mask, causal: bwd(q, k, v, o, do, lse, None, causal)),
    "not_causal": lambda bwd: (
        lambda q, k, v, o, do, lse, mask, causal: bwd(q, k, v, o, do, lse, mask, False)),
    "lse_plus_1e-3": lambda bwd: (
        lambda q, k, v, o, do, lse, mask, causal: bwd(q, k, v, o, do, lse + 1e-3, mask, causal)),
}


def controls() -> int:
    """``--controls``: the card-vs-CPU check with each of ``FAULTS`` patched
    into ``FlashAttention.backward``'s call of the backward kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_controls_") as workdir:
        datasets = _datasets(workdir)
        log(f"control {json.dumps({'fault': None, **card_vs_cpu(datasets, workdir)})}")
        for name, fault in FAULTS.items():
            # the wrapper adds to ``attention.flash_attention_bwd.launches``: the fault's
            attention.flash_attention_bwd = fault(flash_attention_bwd)
            attention.flash_attention_bwd.launches = 0
            try:
                parity = card_vs_cpu(datasets, workdir)
            finally:
                attention.flash_attention_bwd = flash_attention_bwd
            try:
                check_card_vs_cpu(parity)
                caught = False
            except AssertionError:
                caught = True
            log(f"control {json.dumps({'fault': name, 'caught': caught, **parity})}")
    return 0


def hmma_counts(name):
    """Tensor-core instructions (``HMMA``) in each instantiation of the
    kernel library ``name``'s machine code, by ``<dtype>_dh<Dh>``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.library_path(name)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"kernelI(f|13__nv_bfloat16)Li(\d+)E", line)
            key = None if m is None else f"{'f32' if m.group(1) == 'f' else 'bf16'}_dh{m.group(2)}"
            if key is not None:
                counts[key] = 0
        elif key is not None and "HMMA" in line:
            counts[key] += 1
    return counts


def check_tensor_cores(counts):
    want = {f"{d}_dh{dh}" for d in ("bf16", "f32") for dh in attention.HEAD_DIMS}
    if set(counts) != want or not all(counts.values()):
        raise AssertionError(f"the forward kernel is not on tensor cores in every "
                             f"instantiation: HMMA counts {counts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--controls"]:
        return controls()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"build {time.perf_counter() - t0:.1f}s: {sorted(paths)}")
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")
    fwd_hmma = hmma_counts("flash_attention_fwd")
    log(f"sass HMMA in flash_attention_fwd: {json.dumps(fwd_hmma)}")
    check_tensor_cores(fwd_hmma)

    # 3. kernels vs plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd_cases = [check_attention(i, *c) for i, c in enumerate(ATTENTION_CASES + FWD_ONLY_CASES)]
    bwd_cases = [check_attention_bwd(i, *c) for i, c in enumerate(ATTENTION_CASES)]

    # 4. serve through the kernels
    hist = markov_sequences(num_users=3000, num_items=NUM_ITEMS, min_len=1, max_len=80, seed=0)
    hist[0] = []  # one empty history
    requests = [hist[0:1000], hist[1000:2000], hist[2000:3000]]  # 1000 = 3·256 + 232
    serve_launches, serve_bwd_launches = serve(requests, card)

    # 5. train through the kernels
    train_fwd_launches, train_bwd_launches = train(card)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "dr4sr_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "dr4sr_tpu/ops/attention.py:66",
        "launches": train_fwd_launches,
        "launches_by_path": {"serve": serve_launches, "train": train_fwd_launches},
        **{key: fwd_cases[0][key] for key in keys},
        "sass_hmma": fwd_hmma,
        "cases": fwd_cases,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "dr4sr_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "dr4sr_tpu/ops/attention.py:206",
        "launches": train_bwd_launches,
        "launches_by_path": {"serve": serve_bwd_launches, "train": train_bwd_launches},
        **{key: bwd_cases[0][key] for key in keys},
        "cases": bwd_cases,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
