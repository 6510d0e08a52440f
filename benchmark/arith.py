"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
that a piece of work needs, computed from its shapes and masks.

The attention bounds are copies of ``chip_smoke.py``'s
``attention_bound_ms``/``attention_bwd_bound_ms``/``_bound``: each input
read once and each output written once at the HBM rate, or the products
over the (batch, query, key) triples that the masks leave unmasked at the
dtype's peak, whichever is longer. They count a fixed amount of work for a
call, whatever implements it.

:func:`sasrec_step_flops` and :func:`regenerator_step_flops` count the
matrix products and attention of one training step over the real (non-pad)
positions of the batch only, forward and backward as three times the
forward, recomputation not counted.
"""

from __future__ import annotations

import numpy as np

# H100 SXM, NVIDIA's data sheet: HBM3 bytes/s, dense tensor-core FLOP/s.
# f32 products count at the faster of the card's two f32-accurate routes:
# 3xTF32 on tensor cores (495 TFLOP/s of TF32, three products each).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 495e12 / 3
PEAK_FLOPS_BF16 = 989e12


def unmasked_pairs(k_valid: np.ndarray, lq: int, causal: bool) -> int:
    """(batch, query, key) triples left unmasked by a key-padding mask and,
    if ``causal``, by the causal one. ``k_valid`` [B, Lk] bool (True = a real
    key); all ``lq`` query rows count, padded ones too, as the kernels
    compute them."""
    keys = np.asarray(k_valid, bool)
    if not causal:
        return int(keys.sum()) * lq
    # query i sees keys 0..i: cumulative counts of real keys, summed over i < lq
    csum = np.cumsum(keys, axis=1)
    return int(csum[:, np.minimum(np.arange(lq), keys.shape[1] - 1)].sum())


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_FLOPS_F32) -> float:
    """The least time for the work: bytes at the HBM rate or operations at
    the peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def attention_fwd_bound_s(b: int, h: int, lq: int, lk: int, dh: int, k_valid: np.ndarray,
                          causal: bool, elem: int = 4) -> float:
    """Forward: q, k, v and the mask read once, o written once; 4·Dh FLOP
    per unmasked pair and head (q·kᵀ and p·v)."""
    nbytes = 2 * b * h * lq * dh * elem + 2 * b * h * lk * dh * elem + b * lk
    flops = 4 * dh * h * unmasked_pairs(k_valid, lq, causal)
    return bound_s(nbytes, flops)


def attention_bwd_bound_s(b: int, h: int, lq: int, lk: int, dh: int, k_valid: np.ndarray,
                          causal: bool, elem: int = 4) -> float:
    """Backward: q, k, v, o, dO, the row statistics and the mask read once,
    dq, dk, dv written once; 10·Dh FLOP per unmasked pair and head for the
    five products (q·kᵀ, dO·vᵀ, pᵀ·dO, ds·k, dsᵀ·q)."""
    nbytes = elem * 4 * (b * h * lq * dh + b * h * lk * dh) + 4 * b * h * lq + b * lk
    flops = 10 * dh * h * unmasked_pairs(k_valid, lq, causal)
    return bound_s(nbytes, flops)


def _causal_pairs(n: np.ndarray) -> np.ndarray:
    return n * (n + 1) // 2


def _layer_flops(n: np.ndarray, d: int, ffn: int, pairs: np.ndarray) -> np.ndarray:
    """A post-norm encoder layer over n real positions: q, k, v and the
    output projection, the two FFN products, and attention's 4·D per pair."""
    return 2 * n * (4 * d * d + 2 * d * ffn) + 4 * d * pairs


def sasrec_step_flops(seqlen: np.ndarray, d: int, ffn: int, layers: int,
                      num_neg: int = 1) -> float:
    """One SASRec training step over rows of real lengths ``seqlen`` (the
    valid rows only): the encoder (causal) and the positive and negative
    dot products at each real position, times 3 for the backward."""
    n = np.asarray(seqlen, np.int64)
    fwd = layers * _layer_flops(n, d, ffn, _causal_pairs(n)) + 2 * n * d * (1 + num_neg)
    return 3.0 * float(fwd.sum())


def regenerator_step_flops(src_len: np.ndarray, tgt_in_len: np.ndarray, d: int, ffn: int,
                           layers: int, k: int, vocab: int) -> float:
    """One regenerator pretraining step over the real lengths of its framed
    sources and target inputs: the causal encoder over the source, the K
    conditioned memories, the condition encoder (2 causal layers and its
    MLP) over the target, the mixing of the memories, the decoder's
    self-attention, cross-attention and FFN, and the tied logits over the
    whole vocabulary at every real target position; times 3."""
    ls = np.asarray(src_len, np.int64)
    lt = np.asarray(tgt_in_len, np.int64)
    enc = layers * _layer_flops(ls, d, ffn, _causal_pairs(ls))
    cond_mem = 2 * ls * (d * d * k + d * k * d * k)
    cond_enc = 2 * _layer_flops(lt, d, ffn, _causal_pairs(lt)) + 2 * (d * d + d * k)
    mix = 2 * ls * k * d
    dec_self = 2 * lt * 4 * d * d + 4 * d * _causal_pairs(lt)
    dec_cross = 2 * lt * 2 * d * d + 2 * ls * 2 * d * d + 4 * d * lt * ls
    dec_ffn = 2 * lt * 2 * d * ffn
    logits = 2 * lt * d * vocab
    fwd = enc + cond_mem + cond_enc + mix + layers * (dec_self + dec_cross + dec_ffn) + logits
    return 3.0 * float(fwd.sum())
