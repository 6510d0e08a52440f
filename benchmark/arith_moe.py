"""The operations and bytes of the MoE cell: a DeepSeek-V2 decoder step over
the real positions, MLA attention at Dqk ≠ Dv, and the held experts'
grouped products, all against the card's bf16 peak (989 TFLOP/s) and its
HBM rate (``arith``).

:func:`step_flops` counts the matrix products of one training step over
the real (non-pad) positions only: per position, MLA's four projections
(q, the latent kv and k_pe, its up-projection to k_nope and v, the output),
the dense layer's SwiGLU, each MoE layer's router and shared experts, and
the routed experts of the assignments that landed on the held experts (a
count the program's counter gives: it depends on the routing); per causal
pair of real positions and head, q·kᵀ at Dqk and p·v at Dv; the positive
and negative dot products of every real position. The backward counts as
twice the forward; remat's recomputation is not counted.
"""

from __future__ import annotations

import numpy as np

from arith import PEAK_FLOPS_BF16, bound_s, unmasked_pairs


def mla_token_flops(m: dict) -> int:
    """Forward FLOPs of MLA's projections for one position."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    nope, rope, dv, lora = (m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"],
                            m["kv_lora_rank"])
    return 2 * d * (h * (nope + rope) + lora + rope + h * dv) + 2 * lora * h * (nope + dv)


def step_flops(seqlen: np.ndarray, m: dict, held_assignments: int, num_neg: int = 1) -> float:
    """One step over rows of real lengths ``seqlen`` with ``held_assignments``
    top-k assignments on the held experts, summed over the MoE layers;
    forward and backward."""
    n = np.asarray(seqlen, np.int64)
    d, h = m["hidden_size"], m["num_attention_heads"]
    dqk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    layers, dense = m["num_hidden_layers"], m["first_k_dense_replace"]
    tokens = int(n.sum())
    pairs = int((n * (n + 1) // 2).sum())
    per_token = (layers * mla_token_flops(m) + dense * 6 * d * m["intermediate_size"]
                 + (layers - dense) * (2 * d * m["n_routed_experts"]
                                       + 6 * d * m["moe_intermediate_size"]
                                       * m["n_shared_experts"])
                 + 2 * d * (1 + num_neg))
    attention = layers * 2 * h * (dqk + m["v_head_dim"]) * pairs
    routed = 6 * d * m["moe_intermediate_size"] * held_assignments
    return 3.0 * float(tokens * per_token + attention + routed)


def attention_fwd_bound_s(b: int, h: int, lq: int, lk: int, dqk: int, dv: int,
                          k_valid: np.ndarray, causal: bool, elem: int = 2) -> float:
    """Forward: q, k (Dqk), v (Dv), the mask read once, o (Dv) written once;
    2·(Dqk + Dv) FLOP per unmasked pair and head, at the bf16 peak."""
    nbytes = elem * b * h * (lq * dqk + lk * dqk + lk * dv + lq * dv) + b * lk
    flops = 2 * (dqk + dv) * h * unmasked_pairs(k_valid, lq, causal)
    return bound_s(nbytes, flops, PEAK_FLOPS_BF16)


def attention_bwd_bound_s(b: int, h: int, lq: int, lk: int, dqk: int, dv: int,
                          k_valid: np.ndarray, causal: bool, elem: int = 2) -> float:
    """Backward: q, k, v, o, dO, the row statistics and the mask read once,
    dq, dk, dv written once; the five products q·kᵀ, dO·vᵀ, pᵀ·dO, ds·k and
    dsᵀ·q at 2·(3·Dqk + 2·Dv) FLOP per unmasked pair and head."""
    nbytes = (elem * b * h * (2 * lq * dqk + 2 * lk * dqk + 2 * lk * dv + 2 * lq * dv)
              + 4 * b * h * lq + b * lk)
    flops = 2 * (3 * dqk + 2 * dv) * h * unmasked_pairs(k_valid, lq, causal)
    return bound_s(nbytes, flops, PEAK_FLOPS_BF16)


def expert_gemm_bound_s(m: dict, held_assignments: int, moe_layer_passes: int,
                        elem: int = 2) -> float:
    """The held experts' grouped products, forward and backward, over
    ``held_assignments`` rows in all (summed over layers and steps) and
    ``moe_layer_passes`` MoE layer steps (each reads the held experts'
    weights once forward and once backward): 6·D·F FLOP per row forward
    (gate, up, down), twice that backward; bytes: the weights, and each
    row's input (D), hidden (2F in, F out) and output (D), forward once and
    backward twice."""
    d, f, e = m["hidden_size"], m["moe_intermediate_size"], m["n_routed_experts_held"]
    flops = 3 * 6 * d * f * held_assignments
    nbytes = elem * (2 * moe_layer_passes * 3 * e * d * f
                     + 3 * held_assignments * (2 * d + 3 * f))
    return bound_s(nbytes, flops, PEAK_FLOPS_BF16)
