"""Plain PyTorch DR4SR regenerator (``2.Pretrain_regenerator.py``,
``3.Hybrid_inference.py``): a seq2seq transformer whose encoder memory is
mapped to K latent memories, mixed in training by a gumbel-softmax over a
condition encoder of the target, decoded with tied logits limited to the
source's items; the loss is the cross-entropy plus ``entropy_weight`` times
the conditions' entropy; Adam (0.9, 0.98, eps 1e-9) under a cosine decay,
the gumbel temperature ×0.995 a step down to 0.1. At stage 3 each lane is
decoded greedily under one forced condition, restricted to the items of its
source not yet emitted (EOS once none is left, PAD once done).

The weights are drawn from the seed in the port's order (item table with
SOS and EOS, positions, encoder, decoder, condition MLP, condition
encoder); the gumbel draws from a device generator and the dropout masks
from the default generator, both seeded ``seed + 1``, in the order of the
port's forward. Float32, TF32 off unless :func:`plain.precision` says
otherwise. Imports neither the port nor JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from reference import plain

TAU_DECAY = 0.995
TAU_FLOOR = 0.1


def init_params(cfg: dict, seed: int) -> Dict[str, torch.Tensor]:
    """The initial weights, by the port's parameter names, on the CPU."""
    m = cfg["model"]
    d, ffn, k, layers = m["embed_dim"], m["ffn_dim"], m["k"], m["num_layers"]
    w = plain.Draws(seed)
    w.normal("item_embedding.weight", cfg["num_items"] + 2, d)[0].zero_()
    w.normal("position_embedding.weight", m["max_len"], d)
    for i in range(layers):
        w.encoder_layer(f"encoder.layers.{i}", d, ffn)
    for i in range(layers):
        name = f"decoder.layers.{i}"
        for sub, d_in, d_out in (("self_qkv", d, 3 * d), ("self_out", d, d), ("cross_q", d, d),
                                 ("cross_kv", d, 2 * d), ("cross_out", d, d), ("ffn1", d, ffn),
                                 ("ffn2", ffn, d)):
            w.linear(f"{name}.{sub}", d_in, d_out)
        for j in (1, 2, 3):
            w.norm(f"{name}.norm{j}", d)
    w.linear("condition_linear.dense_0", d, d * k)
    w.linear("condition_linear.dense_1", d * k, d * k)
    for i in range(2):
        w.encoder_layer(f"condition_encoder.encoder.layers.{i}", d, ffn)
    w.linear("condition_encoder.condition_layer.dense_0", d, d)
    w.linear("condition_encoder.condition_layer.dense_1", d, k)
    return w.params


def _embed(p, tokens, drop, training):
    pos = p["position_embedding.weight"][: tokens.shape[1]]
    return F.dropout(F.embedding(tokens, p["item_embedding.weight"]) + pos[None], drop, training)


def _encoder(p, prefix, x, key_pad, causal, m, training):
    for i in range(m["num_layers"] if prefix == "encoder" else 2):
        x = plain.encoder_layer(p, f"{prefix}.layers.{i}", x, key_pad, causal, m["num_heads"],
                                m["dropout"], training)
    return x


def _mlp(p, name, x):
    return plain.dense(p, f"{name}.dense_1", F.relu(plain.dense(p, f"{name}.dense_0", x)))


def _decoder(p, x, memory, tgt_pad, mem_pad, m, training):
    h, drop = m["num_heads"], m["dropout"]
    d = x.shape[-1]
    for i in range(m["num_layers"]):
        n = f"decoder.layers.{i}"
        q, k, v = (plain.heads(t, h) for t in plain.dense(p, f"{n}.self_qkv", x).split(d, -1))
        a = plain.attention(q, k, v, tgt_pad, True)
        x = plain.norm(p, f"{n}.norm1", x + F.dropout(plain.dense(p, f"{n}.self_out",
                                                                  plain.merge(a)), drop, training),
                       1e-12)
        k, v = (plain.heads(t, h) for t in plain.dense(p, f"{n}.cross_kv", memory).split(d, -1))
        c = plain.attention(plain.heads(plain.dense(p, f"{n}.cross_q", x), h), k, v, mem_pad, False)
        x = plain.norm(p, f"{n}.norm2", x + F.dropout(plain.dense(p, f"{n}.cross_out",
                                                                  plain.merge(c)), drop, training),
                       1e-12)
        y = F.dropout(plain.gelu(plain.dense(p, f"{n}.ffn1", x)), drop, training)
        x = plain.norm(p, f"{n}.norm3", x + F.dropout(plain.dense(p, f"{n}.ffn2", y), drop,
                                                      training), 1e-12)
    return x


def _memories(p, src, causal, m, training):
    """[B, Ls, K, D] latent memories of the sources."""
    memory = _encoder(p, "encoder", _embed(p, src, m["dropout"], training), src == 0, causal, m,
                      training)
    b, l, d = memory.shape
    return _mlp(p, "condition_linear", memory).reshape(b, l, m["k"], d)


def _logits(p, out):
    return torch.matmul(out, p["item_embedding.weight"].T)


def train_loss(p, src, tgt, tgt_len, tau, gumbel_gen, cfg, keep_rows=None):
    """The pretraining loss of a batch (teacher-forced on ``tgt[:, :-1]``),
    the gumbel noise drawn from ``gumbel_gen`` where the port draws it."""
    m = cfg["model"]
    tgt_in, targets = tgt[:, :-1], tgt[:, 1:]
    mem_k = _memories(p, src, True, m, True)
    tgt_emb = _embed(p, tgt_in, m["dropout"], True)
    u = torch.rand((src.shape[0], m["k"]), generator=gumbel_gen, device=src.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    out = _encoder(p, "condition_encoder.encoder", tgt_emb, tgt_in == 0, True, m, True)
    real = torch.arange(out.shape[1], device=out.device)[None, :] < tgt_len[:, None]
    pooled = torch.where(real[..., None], out, 0.0).sum(1) / tgt_len.clamp_min(1)[:, None].float()
    cond = F.softmax((_mlp(p, "condition_encoder.condition_layer", pooled) + gumbel) / tau, -1)
    memory = torch.einsum("blkd,bk->bld", mem_k, cond)
    out = _decoder(p, tgt_emb, memory, tgt_in == 0, src == 0, m, True)
    logits = _logits(p, out)
    keep = torch.zeros(src.shape[0], logits.shape[-1], dtype=torch.bool, device=src.device)
    keep.scatter_(1, src, True)
    logits = torch.where(keep[:, None, :], logits, plain.NEG)
    mask = targets != 0
    if keep_rows is not None:
        mask = mask & keep_rows[:, None]
    nll = -F.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]
    ce = torch.where(mask, nll, 0.0).sum() / mask.sum().clamp_min(1)
    ent = -(cond * torch.log(cond + 1e-12)).sum(-1).mean()
    return ce + cfg["train"]["entropy_weight"] * ent


def cosine(total_steps: int):
    return lambda step: 0.5 * (1.0 + math.cos(math.pi * min(step, total_steps) / total_steps))


class Run:
    """Pretraining steps of the reference from the seed, with what the
    comparison reads kept as it goes."""

    def __init__(self, cfg: dict, seed: int, device, total_steps: int, tf32: bool = False,
                 half_batch: bool = False) -> None:
        self.cfg, self.device, self.tf32, self.half_batch = cfg, device, tf32, half_batch
        self.init = init_params(cfg, seed)
        self.params = plain.on(self.init, device, grad=True)
        t = cfg["train"]
        self.opt = torch.optim.Adam(plain.leaves(self.params), lr=t["learning_rate"],
                                    betas=(0.9, 0.98), eps=1e-9)
        self.sched = torch.optim.lr_scheduler.LambdaLR(self.opt, cosine(total_steps))
        self.gumbel_gen = torch.Generator(device=device).manual_seed(seed + 1)
        torch.manual_seed(seed + 1)
        self.tau = 1.0
        self.losses: List[float] = []
        self.moment1 = self.after3 = None

    def step(self, src, tgt, tgt_len) -> float:
        keep = None
        if self.half_batch:  # the fault: the second half of the rows left out
            keep = torch.arange(src.shape[0], device=self.device) < src.shape[0] // 2
        self.opt.zero_grad(set_to_none=True)
        with plain.precision(self.tf32):
            loss = train_loss(self.params, src, tgt, tgt_len, self.tau, self.gumbel_gen, self.cfg,
                              keep)
            loss.backward()
        self.opt.step()
        self.sched.step()
        self.tau = max(self.tau * TAU_DECAY, TAU_FLOOR)
        self.losses.append(float(loss.detach()))
        if len(self.losses) == 1:
            self.moment1 = {k: self.opt.state[p]["exp_avg"].detach().clone()
                            for k, p in self.params.items()}
        if len(self.losses) == 3:
            self.after3 = {k: p.detach().clone() for k, p in self.params.items()}
        return self.losses[-1]


@torch.no_grad()
def forced_logits(p, src: torch.Tensor, condition: torch.Tensor, buf: torch.Tensor,
                  cfg: dict) -> torch.Tensor:
    """[B, T, V] eval-mode logits at every position of the token buffers
    ``buf`` [B, T] (SOS first), each lane under its forced condition: the
    full decoder over the buffer, causal, PAD keys masked."""
    m = cfg["model"]
    mem_k = _memories(p, src, False, m, False)
    idx = condition[:, None, None, None].expand(mem_k.shape[0], mem_k.shape[1], 1, mem_k.shape[3])
    memory = mem_k.gather(2, idx)[:, :, 0]
    out = _decoder(p, _embed(p, buf, 0.0, False), memory, buf == 0, src == 0, m, False)
    return _logits(p, out)


def _served(src: torch.Tensor, tokens: List[List[int]], t: int, v: int, eos: int):
    """For lanes served ``tokens`` (SOS and the stop stripped), at each of
    ``t`` positions: the token served there ([B, T], the stop as EOS), the
    positions judged (up to and with the stop), and the allowed items (those
    of the source, SOS and EOS included, PAD never, not yet emitted; SOS is
    emitted from the start) [B, T, V]."""
    b, dev = len(tokens), src.device
    served = torch.zeros(b, t, dtype=torch.long)
    judged = torch.zeros(b, t, dtype=torch.bool)
    for i, toks in enumerate(tokens):
        row = (list(toks) + ([eos] if len(toks) < t else []))[:t]
        served[i, :len(row)] = torch.tensor(row, dtype=torch.long)
        judged[i, :len(row)] = True
    served, judged = served.to(dev), judged.to(dev)
    in_src = torch.zeros(b, v, dtype=torch.bool, device=dev).scatter_(1, src, True)
    in_src[:, 0] = False
    in_src[:, eos - 1] = False  # SOS = num_items = eos - 1
    # the tokens served before each position
    emitted = torch.zeros(b, t, v, dtype=torch.int32, device=dev)
    emitted.scatter_(2, served[:, :, None], judged[:, :, None].int())
    before = (emitted.cumsum(1, dtype=torch.int32) - emitted) > 0
    return served, judged, in_src[:, None, :] & ~before


def judge_lanes(logits: torch.Tensor, src: torch.Tensor, tokens: List[List[int]],
                eos: int) -> np.ndarray:
    """Per lane, the widest gap by which a served token's logit lies below
    the best allowed one, over the positions up to and with its stop; with
    no item allowed, EOS is the only answer (gap 0 if served, else 1e9); a
    served token that is not allowed reads 1e9 (see :func:`_served`)."""
    b, t, v = logits.shape
    served, judged, allowed = _served(src, tokens, t, v, eos)
    logits = logits.float()
    best = torch.where(allowed, logits, -math.inf).amax(-1)
    gap = best - logits.gather(2, served[..., None])[..., 0]
    ok = allowed.gather(2, served[..., None])[..., 0]
    none = ~allowed.any(-1)
    gap = torch.where(none, torch.where(served == eos, 0.0, 1e9),
                      torch.where(ok, gap, 1e9))
    return torch.where(judged, gap.double(), 0.0).amax(1).cpu().numpy()


def control_gaps(ref_logits: torch.Tensor, low_logits: torch.Tensor, src: torch.Tensor,
                 tokens: List[List[int]], eos: int) -> np.ndarray:
    """The control for decoding: at each judged position of the same lanes
    and tokens, the gap (under ``ref_logits``) of the token that the lower
    precision's ``low_logits`` put first among the allowed ones."""
    b, t, v = ref_logits.shape
    _, judged, allowed = _served(src, tokens, t, v, eos)
    ref, low = ref_logits.float(), low_logits.float()
    pick = torch.where(allowed, low, -math.inf).argmax(-1, keepdim=True)
    gap = torch.where(allowed, ref, -math.inf).amax(-1) - ref.gather(2, pick)[..., 0]
    gap = torch.where(judged & allowed.any(-1), gap.double(), 0.0)
    return gap.amax(1).cpu().numpy()


def served_buffers(tokens: List[List[int]], sos: int, eos: int, max_len: int) -> np.ndarray:
    """[B, max_len] buffers: SOS, the served items, EOS if they stopped short, then PAD."""
    buf = np.zeros((len(tokens), max_len), np.int64)
    buf[:, 0] = sos
    for i, toks in enumerate(tokens):
        toks = list(toks)[: max_len - 1]
        buf[i, 1: 1 + len(toks)] = toks
        if len(toks) < max_len - 1:
            buf[i, 1 + len(toks)] = eos
    return buf

