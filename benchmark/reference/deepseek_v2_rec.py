"""The benchmark's plain float32 reference of the ``deepseek-v2-lite-rec``
configuration (a copy of the port's ``reference/deepseek_v2.py``, which it
does not import): DeepSeek-V2's decoder as the encoder of a sequential
recommender, with no kernel, cache, grouped product or batching trick.
Imports only torch; matrix products run in full f32 (TF32 off).

The equations (arXiv:2405.04434 §2; DeepSeek-V2-Lite's config.json):

    x_0 = E[item ids]                                  (E: the item table)
    x_l = x_{l-1} + MLA(RMSNorm(x_{l-1}))
    x_l = x_l + MLP_l(RMSNorm(x_l))                    (l = 1 .. layers)
    out = RMSNorm(x_L)
    RMSNorm(x) = w ⊙ x / sqrt(mean(x²) + eps)
    SwiGLU(x) = W_down (silu(W_gate x) ⊙ W_up x)

MLA without q-LoRA, per head h: [q_nope | q_pe] = W_q x; [c_kv | k_pe] =
W_kva x (k_pe one vector for all heads); [k_nope | v] = W_kvb
RMSNorm(c_kv); q_pe and k_pe rotated by YaRN RoPE, pair (2i, 2i+1) by angle
p·f_i (DeepSeek's code moves the even elements before the odd ones first,
which permutes q_pe and k_pe alike and changes no score); scores
[q_nope | q_pe]·[k_nope | k_pe] times Dqk^-½·mscale², causal and without
pad keys; o = softmax·v; W_o over the heads. YaRN: f_i interpolates between
θ^(-2i/d) and θ^(-2i/d)/factor with a linear ramp over the correction range
of β_fast and β_slow; mscale = 0.1·mscale_all_dim·ln(factor) + 1.

MLP: layer 1 (``first_k_dense_replace``) a dense SwiGLU; then DeepSeekMoE:
p = softmax(W_router x) in f32 over all routed experts, the greedy top-k,
weights p (divided by their sum only with ``norm_topk_prob``) times
``routed_scaling_factor``; out = Σ_{kept e} weight_e·SwiGLU_e(x) +
SwiGLU_shared(x). Here each expert runs as a dense SwiGLU on the tokens
routed to it.

Departures, as the port's model (``models/deepseek_v2.py``) makes them:
the scores are dot products of ``out`` against the input table (tied:
DeepSeek-V2 has ``tie_word_embeddings: false``); no aux balance loss (the
config gives it no weight); a MoE layer holds experts ``expert_offset`` ..
``expert_offset + n_routed_experts_held - 1`` and adds only theirs (one
device's share of an expert-parallel layer), or, with
``fold_foreign_experts``, also gives each assignment to an expert held
elsewhere to held expert ``expert_offset + (e - expert_offset) mod
n_routed_experts_held`` (standing in for the rows the other devices'
tokens send to this one); pad positions go to no routed expert.
Training loss: per-position BCE against one uniform negative over the
real targets, as ``modules/losses.py``.

``Options`` plants the departures a check must catch: operands of every
product rounded to another precision (``operand``), top-k of another k,
the shared experts dropped, the top-k weights renormalised, the rope left
off q_pe.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
NEG = -1e30


@dataclasses.dataclass
class Options:
    operand: Optional[Callable[[torch.Tensor], torch.Tensor]] = None  # rounds each product's operands
    top_k: Optional[int] = None  # None: the config's
    shared: bool = True
    renormalise: Optional[bool] = None  # None: the config's norm_topk_prob
    rope_q: bool = True


PLAIN = Options()


@contextlib.contextmanager
def full_f32():
    """Matrix products in full f32: TF32 off for cuBLAS and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def param_shapes(m: dict, num_items: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter in the order the weights are
    drawn: 'normal' is normal(0.02), 'ones' draws nothing; the item table's
    PAD row is zeroed after its draw."""
    d = m["hidden_size"]
    h, nope, rope, dv = (m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                         m["v_head_dim"])
    out = [("item_embedding.weight", (num_items, d), "normal")]
    for i in range(m["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm.weight", (d,), "ones"),
                (p + "attn.w_q", (h * (nope + rope), d), "normal"),
                (p + "attn.w_kva", (m["kv_lora_rank"] + rope, d), "normal"),
                (p + "attn.kv_norm.weight", (m["kv_lora_rank"],), "ones"),
                (p + "attn.w_kvb", (h * (nope + dv), m["kv_lora_rank"]), "normal"),
                (p + "attn.w_o", (d, h * dv), "normal"),
                (p + "mlp_norm.weight", (d,), "ones")]
        if i < m["first_k_dense_replace"]:
            f = m["intermediate_size"]
            out += [(p + "mlp.w_gate", (f, d), "normal"), (p + "mlp.w_up", (f, d), "normal"),
                    (p + "mlp.w_down", (d, f), "normal")]
        else:
            e, f = m["n_routed_experts_held"], m["moe_intermediate_size"]
            fs = f * m["n_shared_experts"]
            out += [(p + "mlp.gate", (m["n_routed_experts"], d), "normal"),
                    (p + "mlp.w_gate", (e, f, d), "normal"), (p + "mlp.w_up", (e, f, d), "normal"),
                    (p + "mlp.w_down", (e, d, f), "normal"),
                    (p + "mlp.shared.w_gate", (fs, d), "normal"),
                    (p + "mlp.shared.w_up", (fs, d), "normal"),
                    (p + "mlp.shared.w_down", (d, fs), "normal")]
    out.append(("norm.weight", (d,), "ones"))
    return out


def init_params(m: dict, num_items: int, seed: int) -> Params:
    """The initial weights on the CPU, drawn from ``seed`` in order."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, shape, init in param_shapes(m, num_items):
        if init == "ones":
            params[name] = torch.ones(shape)
        else:
            params[name] = torch.empty(shape).normal_(0.0, 0.02, generator=gen)
    params["item_embedding.weight"][0].zero_()
    return params


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, base: float, factor: float, original: int, beta_fast: float,
                  beta_slow: float) -> torch.Tensor:
    def corr(rot):
        return dim * math.log(original / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = max(math.floor(corr(beta_fast)), 0), min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(0, dim, 2, dtype=torch.float32)
    extra = 1.0 / (base ** (i / dim))
    inter = 1.0 / (factor * base ** (i / dim))
    mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return inter * (1 - mask) + extra * mask


def softmax_scale(m: dict) -> float:
    r = m["rope_scaling"]
    return ((m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
            * yarn_mscale(r["factor"], r["mscale_all_dim"]) ** 2)


def _mm(a: torch.Tensor, w: torch.Tensor, o: Options) -> torch.Tensor:
    """a · wᵀ, the operands rounded by ``o.operand`` first if set."""
    if o.operand is not None:
        a, w = o.operand(a), o.operand(w)
    return torch.matmul(a, w.transpose(-1, -2))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def swiglu(x, w_gate, w_up, w_down, o: Options) -> torch.Tensor:
    return _mm(F.silu(_mm(x, w_gate, o)) * _mm(x, w_up, o), w_down, o)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    even, odd = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack((even * c - odd * s, even * s + odd * c), dim=-1).flatten(-2)


def mla(p: Params, pre: str, x: torch.Tensor, pad: torch.Tensor, m: dict,
        o: Options) -> torch.Tensor:
    b, l, _ = x.shape
    h, nope, rope, dv = (m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                         m["v_head_dim"])
    r = m["rope_scaling"]
    q = _mm(x, p[pre + "w_q"], o).view(b, l, h, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = _mm(x, p[pre + "w_kva"], o)
    c, k_pe = ckv[..., :m["kv_lora_rank"]], ckv[..., m["kv_lora_rank"]:]
    kv = _mm(rmsnorm(c, p[pre + "kv_norm.weight"], m["rms_norm_eps"]), p[pre + "w_kvb"], o)
    kv = kv.view(b, l, h, nope + dv)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    inv = yarn_inv_freq(rope, m["rope_theta"], r["factor"], r["original_max_position_embeddings"],
                        r["beta_fast"], r["beta_slow"]).to(x.device)
    ang = torch.outer(torch.arange(l, dtype=torch.float32, device=x.device), inv)
    ms = yarn_mscale(r["factor"], r["mscale"]) / yarn_mscale(r["factor"], r["mscale_all_dim"])
    cos, sin = ang.cos() * ms, ang.sin() * ms
    if o.rope_q:
        q_pe = _rotate(q_pe, cos, sin)
    k_pe = _rotate(k_pe[:, :, None, :], cos, sin).expand(b, l, h, rope)
    qh = torch.cat((q_nope, q_pe), -1).transpose(1, 2)  # [B, H, L, 192]
    kh = torch.cat((k_nope, k_pe), -1).transpose(1, 2)
    vh = v.transpose(1, 2)
    s = _mm(qh, kh, o) * softmax_scale(m)
    invalid = (torch.arange(l, device=x.device)[None, :] > torch.arange(l, device=x.device)[:, None])
    invalid = invalid[None, None] | pad[:, None, None, :]
    s = s.masked_fill(invalid, NEG)
    e = torch.exp(s - s.amax(-1, keepdim=True).detach()).masked_fill(invalid, 0.0)
    prob = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = _mm(prob, vh.transpose(-1, -2), o)  # [B, H, L, 128]
    return _mm(out.transpose(1, 2).reshape(b, l, h * dv), p[pre + "w_o"], o)


def moe(p: Params, pre: str, x: torch.Tensor, real: torch.Tensor, m: dict,
        o: Options) -> torch.Tensor:
    """The held experts' share and the shared experts, x [B, L, D]."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    probs = _mm(xf, p[pre + "gate"], o).softmax(-1)
    k = o.top_k or m["num_experts_per_tok"]
    w, idx = torch.topk(probs, k, dim=-1)
    renorm = m["norm_topk_prob"] if o.renormalise is None else o.renormalise
    if renorm:
        w = w / w.sum(-1, keepdim=True)
    w = w * m["routed_scaling_factor"]
    y = torch.zeros_like(xf)
    real = real.reshape(-1)
    held = m["n_routed_experts_held"]
    local = idx - m.get("expert_offset", 0)
    if m.get("fold_foreign_experts", False):
        local = local % held
    for e in range(held):
        hit = (local == e) & real[:, None]
        tok, slot = hit.nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(xf[tok], p[pre + "w_gate"][e], p[pre + "w_up"][e], p[pre + "w_down"][e], o)
        y = y.index_add(0, tok, out * w[tok, slot][:, None])
    if o.shared:
        y = y + swiglu(xf, p[pre + "shared.w_gate"], p[pre + "shared.w_up"],
                       p[pre + "shared.w_down"], o)
    return y.reshape(shape)


def encode(p: Params, seq: torch.Tensor, m: dict, o: Options = PLAIN) -> torch.Tensor:
    """[B, L] item ids → [B, L, D] states after the final norm."""
    pad = seq == 0
    x = F.embedding(seq, p["item_embedding.weight"])
    eps = m["rms_norm_eps"]
    for i in range(m["num_hidden_layers"]):
        pre = f"layers.{i}."
        x = x + mla(p, pre + "attn.", rmsnorm(x, p[pre + "attn_norm.weight"], eps), pad, m, o)
        h = rmsnorm(x, p[pre + "mlp_norm.weight"], eps)
        if i < m["first_k_dense_replace"]:
            x = x + swiglu(h, p[pre + "mlp.w_gate"], p[pre + "mlp.w_up"], p[pre + "mlp.w_down"], o)
        else:
            x = x + moe(p, pre + "mlp.", h, ~pad, m, o)
    return rmsnorm(x, p["norm.weight"], eps)


def bce_sum(p: Params, x: torch.Tensor, seqlen: torch.Tensor, item_id: torch.Tensor,
            neg: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ over the real targets of the valid rows of −log σ(pos) +
    softplus(neg), their count), the states ``x`` zeroed at pad positions."""
    real = torch.arange(x.shape[1], device=x.device)[None, :] < seqlen[:, None]
    query = torch.where(real[..., None], x, 0.0)
    table = p["item_embedding.weight"]
    pos = (query * F.embedding(item_id, table)).sum(-1)
    neg_s = (query[:, :, None, :] * F.embedding(neg, table)).sum(-1)
    mask = ((item_id != 0) & valid[:, None]).float()
    total = (-F.logsigmoid(pos) * mask).sum() + (F.softplus(neg_s).mean(-1) * mask).sum()
    return total, mask.sum()


def loss(p: Params, batch: Dict[str, torch.Tensor], neg: torch.Tensor, m: dict,
         o: Options = PLAIN) -> torch.Tensor:
    """The training loss of a batch (in_item_id, seqlen, item_id, valid)."""
    with full_f32():
        x = encode(p, batch["in_item_id"], m, o)
        total, count = bce_sum(p, x, batch["seqlen"], batch["item_id"], neg, batch["valid"])
    return total / count.clamp_min(1.0)


@torch.no_grad()
def serve_scores(p: Params, seq: torch.Tensor, seqlen: torch.Tensor, m: dict,
                 o: Options = PLAIN) -> torch.Tensor:
    """[B, N] scores of the whole catalog from the last real position's
    state, PAD and the items of ``seq`` at -1e30."""
    with full_f32():
        x = encode(p, seq, m, o)
        last = x[torch.arange(x.shape[0], device=x.device), (seqlen - 1).clamp(0, x.shape[1] - 1)]
        scores = torch.matmul(last, p["item_embedding.weight"].T)
    scores[:, 0] = NEG
    return scores.scatter(1, seq, NEG)
