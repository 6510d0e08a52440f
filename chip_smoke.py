#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dr4sr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of the repository

Phases, in order; any failure raises and the script exits nonzero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the package, from ``dr4sr_tpu_torch/ops/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   serving shape and a stress shape, with and without a key-padding mask
   (one fully masked row per batch), with its time beside the plain version's,
   one PyTorch library call's and the least time the card could take;
4. serve: ``Recommender(device="cuda")`` answers three requests of 1,000
   histories on SASRec at the amazon-toys width (random weights from seed 0),
   through the kernels, and agrees with the same weights on the CPU route;
   then times one-batch requests, and profiles one more pass with
   ``torch.profiler`` (device time by kernel, host time by op, busy share).

It prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dr4sr_tpu_torch.data.synthetic import markov_sequences
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.ops import _build
from dr4sr_tpu_torch.ops.attention import flash_attention, mha_reference
from dr4sr_tpu_torch.serve import Recommender

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and dense
# FLOP/s for f32 on CUDA cores and for bf16 on tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # as tests/test_attention.py

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


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 21, inner: int = 5) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def attention_bound_ms(q, k, v, pad, causal):
    """The least time for this call: each input read once and the output
    written once at the HBM rate, or the products that this data needs
    (q·kᵀ and p·v over unmasked pairs) at the dtype's peak."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() + pad.numel()
    pairs = (~pad)[:, None, :].expand(b, lq, lk)
    if causal:
        pairs = pairs & torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
    flops = 4 * dh * h * int(pairs.sum())
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_attention(seed, name, b, h, lq, lk, dh, causal, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, dh, generator=gen, device="cuda").to(dtype)
               for n in (lq, lk, lk))
    seqlen = torch.randint(0, lk + 1, (b,), generator=gen, device="cuda")
    seqlen[0] = 0  # one fully masked row in every batch
    pad = torch.arange(lk, device="cuda")[None, :] >= seqlen[:, None]
    with torch.no_grad():
        out = flash_attention(q, k, v, pad, causal)
        out_nomask = flash_attention(q, k, v, None, causal)
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
        ms = time_ms(lambda: flash_attention(q, k, v, pad, causal))
        plain_ms = time_ms(lambda: mha_reference(q, k, v, pad, causal))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attend))
    bound_ms, bound_by = attention_bound_ms(q, k, v, pad, causal)
    case = {"case": name, "shape": [b, h, lq, lk, dh], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "atol": ATOL[dtype],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"kernel case {json.dumps(case)}")
    return case


def serve(requests, card):
    """Serve ``requests`` on the card; check the answers; time them."""
    module = SASRec.build(CONFIG, NUM_ITEMS, generator=torch.Generator().manual_seed(0))
    rec = RecModel(CONFIG, module, NUM_ITEMS, 0)
    gpu = Recommender(rec, module.state_dict(), batch_size=BATCH, device="cuda")
    gpu.recommend(requests[0][:BATCH], k=TOPK)  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    flash_attention.launches = 0
    t0 = time.perf_counter()
    answers = [gpu.recommend(r, k=TOPK) for r in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches

    L = CONFIG["data"]["max_seq_len"]
    batches = sum(-(-len(r) // BATCH) for r in requests)
    want = CONFIG["model"]["layer_num"] * batches
    if launches != want:
        raise AssertionError(f"flash_attention launched {launches} times, expected {want}")
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
              "attention_launches": launches, "card": card}
    log(f"serve {json.dumps(result)}")
    profile_serve(gpu, requests)
    return launches


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
    events = prof.key_averages()
    # kernel rows only: an op's row repeats the device time of its kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile wall_us {wall_us:.1f} device_busy_us {device_us:.1f} "
        f"busy_share {device_us / wall_us:.4f} (profiler on)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  device_us {e.self_device_time_total:10.1f} calls {e.count:6d} {e.key[:90]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"  host_us {e.self_cpu_time_total:10.1f} calls {e.count:6d} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

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
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 3. kernel vs plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [check_attention(i, *c) for i, c in enumerate(ATTENTION_CASES)]

    # 4. serve through the kernels
    hist = markov_sequences(num_users=3000, num_items=NUM_ITEMS, min_len=1, max_len=80, seed=0)
    hist[0] = []  # one empty history
    requests = [hist[0:1000], hist[1000:2000], hist[2000:3000]]  # 1000 = 3·256 + 232
    launches = serve(requests, card)

    main_case = cases[0]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "dr4sr_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "dr4sr_tpu/ops/attention.py:66",
        "launches": launches,
        **{key: main_case[key] for key in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "cases": cases,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
