"""Batched hybrid-inference decoding.

Port of ``dr4sr_tpu/regen/decode.py``: every lane of a batch [B] decodes at
once, K conditions as K passes over the same sources, with the reference's
masking (``inference_mask`` / ``inference_mask_generative``):

* restrictive: only items of the source not yet emitted;
* generative: any item not yet emitted;
* PAD is never allowed; a lane with nothing allowed emits EOS, a lane
  already done emits PAD;
* each lane picks generative with probability γ at steps after the first
  two (γ = 0, as shipped, is always restrictive).

The JAX loops are ``lax.fori_loop``s over fixed shapes; here the batch
functions are Python loops over the same shapes, and every one of the
``max_len - 1`` steps runs even when every lane is done. The per-step
uniform draws for γ > 0 come from a ``torch.Generator``, or as ``draws``
[max_len - 1, B] (a beam search draws one per source, as JAX does).
Decoding runs where the generator's weights are, in eval mode, without
gradients.

On a CUDA device ``decode_dataset``'s default path (greedy, KV-cached)
runs a batch as one replay of a CUDA graph that holds the whole of
:func:`greedy_decode_batch_cached` (``decode_state`` through the encoder
kernel, the source mask, the caches and buffers, every position), where
the Python loop launches some 120 kernels a position: the same kernels in
the same order, so the same tokens to the bit (:class:`_DecodeGraphs`).
Beam search, the uncached path, the CPU and the batch functions called
directly run eagerly.

``decode_dataset(..., mesh_plan=)`` shards the lanes over the ``data`` axis
(JAX's ``decode.py:304``, ``:327-331``): each rank decodes a contiguous
share of every batch's lanes, the γ draws [max_len − 1, B] are drawn for
the whole batch on every rank and sliced, and the token buffers are
all-gathered, so every rank returns the same list, the one one process
returns.

Under a ``torch.profiler`` session the loops carry spans
(``utils/spans.py``): each eager batch records ``regen.encode`` once (the
encoder or ``decode_state``, the source mask, the caches and buffers) and
``regen.position`` once for each of its ``max_len - 1`` positions (the
step, the pick, the buffer updates); a replayed batch records
``regen.replay`` once (the copies into the graph's inputs and the launch);
and each batch of ``decode_dataset`` then records ``regen.collect`` once
(the all-gather, the copy back, the lanes' token lists). A batch that
captures records its capture's eager spans, then ``regen.replay``.
"""

from __future__ import annotations

import copy
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dr4sr_tpu_torch.ops.graphs import CudaGraphs
from dr4sr_tpu_torch.ops.topk import top_k_stable
from dr4sr_tpu_torch.parallel.collectives import all_gather
from dr4sr_tpu_torch.parallel.mesh import DATA_AXIS, MeshPlan
from dr4sr_tpu_torch.regen.generator import NEG, Generator
from dr4sr_tpu_torch.utils.spans import span


def _lane_draws(gamma, draws, generator, steps, b, device) -> Optional[torch.Tensor]:
    """[steps, b] uniforms for the generative choice, or None when γ = 0."""
    if gamma <= 0.0:
        return None
    if draws is None:
        return torch.rand((steps, b), generator=generator, device=device)
    return torch.as_tensor(draws, dtype=torch.float32, device=device)


def _source_mask(src: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, V] True at the items of each source; PAD never."""
    in_src = torch.zeros(src.shape[0], vocab, dtype=torch.bool, device=src.device)
    in_src.scatter_(1, src.long(), True)
    in_src[:, 0] = False
    return in_src


def _allowed(in_src, emitted, u, gamma, i) -> torch.Tensor:
    """This step's allowed items per lane: restrictive, or generative for
    lanes whose draw falls under γ after step 1."""
    restr = in_src & ~emitted
    if u is None or i <= 1:
        return restr
    gen = ~emitted
    gen[..., 0] = False
    use_generative = u[i] < gamma
    use_generative = use_generative.reshape(use_generative.shape + (1,) * (restr.dim() - 1))
    return torch.where(use_generative, gen, restr)


def _greedy_pick(logits, allowed, done, eos) -> torch.Tensor:
    nxt = torch.where(allowed, logits, NEG).argmax(dim=-1)
    dead = ~allowed.any(dim=-1)
    return torch.where(done, 0, torch.where(dead, eos, nxt))


def _start(src: torch.Tensor, generator: Generator, max_len: int, lanes=()):
    """SOS-started buffers, the emitted masks (SOS emitted) and done flags."""
    b = src.shape[0]
    vocab = generator.num_items + 2
    buf = torch.zeros((b, *lanes, max_len), dtype=torch.long, device=src.device)
    buf[..., 0] = generator.sos
    emitted = torch.zeros((b, *lanes, vocab), dtype=torch.bool, device=src.device)
    emitted[..., generator.sos] = True
    done = torch.zeros((b, *lanes), dtype=torch.bool, device=src.device)
    return buf, emitted, done


@torch.no_grad()
def greedy_decode_batch(
    generator: Generator,
    src: torch.Tensor,  # [B, Ls] SOS/EOS-framed, 0-padded
    condition: torch.Tensor,  # [B] condition index per lane
    max_len: int = 25,
    gamma: float = 0.0,
    rng: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-buffer greedy decode: each step reruns the decoder over the whole
    buffer. Token buffers [B, max_len] (SOS first, EOS-terminated, 0 after)."""
    with span("regen.encode"):
        generator.eval()
        b = src.shape[0]
        memory_k = generator.conditioned_memory(generator.encode(src, causal=False))
        src_pad = src == 0
        in_src = _source_mask(src, generator.num_items + 2)
        u = _lane_draws(gamma, draws, rng, max_len - 1, b, src.device)
        buf, emitted, done = _start(src, generator, max_len)
        rows = torch.arange(b, device=src.device)
    for i in range(max_len - 1):
        with span("regen.position"):
            logits = generator.decode_step(buf, memory_k, src_pad, condition, i)
            nxt = _greedy_pick(logits, _allowed(in_src, emitted, u, gamma, i), done,
                               generator.eos)
            buf[:, i + 1] = nxt
            emitted[rows, nxt] = True
            done |= nxt == generator.eos
    return buf


def _caches(generator: Generator, lanes: int, max_len: int, like: torch.Tensor):
    shape = (generator.num_layers, lanes, max_len, generator.embed_dim)
    return (torch.zeros(shape, dtype=like.dtype, device=like.device),
            torch.zeros(shape, dtype=like.dtype, device=like.device))


@torch.no_grad()
def greedy_decode_batch_cached(
    generator: Generator,
    src: torch.Tensor,
    condition: torch.Tensor,
    max_len: int = 25,
    gamma: float = 0.0,
    rng: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KV-cached greedy decode, the default: the same tokens as
    :func:`greedy_decode_batch`, but each step advances one position through
    per-layer self-attention caches, with the cross-attention k, v projected
    once. The encoder is the only attention through the kernels here. It
    runs eagerly; ``decode_dataset`` captures it into a CUDA graph on the
    card, so it must make no host sync and copy no host value to the
    device (the emitted mask is set by ``scatter_``, whose scalar a capture
    takes as a kernel argument)."""
    with span("regen.encode"):
        generator.eval()
        b = src.shape[0]
        mem_k, mem_v = generator.decode_state(src, condition)
        memory_valid = src != 0
        in_src = _source_mask(src, generator.num_items + 2)
        u = _lane_draws(gamma, draws, rng, max_len - 1, b, src.device)
        cache_k, cache_v = _caches(generator, b, max_len, mem_k)
        buf, emitted, done = _start(src, generator, max_len)
    for i in range(max_len - 1):
        with span("regen.position"):
            logits = generator.cached_decode_step(buf[:, i], i, cache_k, cache_v, mem_k, mem_v,
                                                  memory_valid)
            nxt = _greedy_pick(logits, _allowed(in_src, emitted, u, gamma, i), done,
                               generator.eos)
            buf[:, i + 1] = nxt
            emitted.scatter_(1, nxt[:, None], True)
            done |= nxt == generator.eos
    return buf


class _DecodeGraphs:
    """A generator's CUDA graphs of :func:`greedy_decode_batch_cached`, a
    batch one replay (``ops/graphs.py``), and what they stage: each key's
    static sources, conditions and draws, which a replay copies the
    batch's into on the current stream before the launch. A graph's key is
    what the batch's code depends on: its lanes and source width,
    ``max_len``, γ (a constant of the graph) and the weights' dtype. A
    parameter, buffer or submodule of the generator rebound to other
    storage drops every graph, to be captured again."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = CudaGraphs(device)
        self.inputs: Dict[tuple, list] = {}

    def decode(self, generator: Generator, src, condition, max_len: int, gamma: float,
               draws: Optional[torch.Tensor]) -> torch.Tensor:
        graphs = self.cuda
        graphs.watch(generator)
        key = (tuple(src.shape), max_len, gamma, generator.item_embedding.weight.dtype)
        if key not in graphs.warm:
            return graphs.run(key, lambda: greedy_decode_batch_cached(
                generator, src, condition, max_len, gamma, draws=draws))
        if key not in graphs.graphs:
            inputs = self.inputs[key] = [
                t.clone(memory_format=torch.contiguous_format) if t is not None else None
                for t in (src, condition, draws)]
            graphs.capture(key, lambda: greedy_decode_batch_cached(
                generator, *inputs[:2], max_len, gamma, draws=inputs[2]))
        with span("regen.replay"):
            for static, t in zip(self.inputs[key], (src, condition, draws)):
                if t is not None:
                    static.copy_(t)
            return graphs.replay(key)


# the graphs of each generator on the card, dropped with it; neither
# ``copy.deepcopy`` nor ``state_dict`` sees them
_GRAPHS: "weakref.WeakKeyDictionary[Generator, _DecodeGraphs]" = weakref.WeakKeyDictionary()


def _graphs_of(generator: Generator, device: torch.device) -> _DecodeGraphs:
    graphs = _GRAPHS.get(generator)
    if graphs is None or graphs.cuda.device != device:
        graphs = _GRAPHS[generator] = _DecodeGraphs(device)
    return graphs


@torch.no_grad()
def beam_decode_batch_cached(
    generator: Generator,
    src: torch.Tensor,
    condition: torch.Tensor,
    max_len: int = 25,
    gamma: float = 0.0,
    beam_width: int = 4,
    rng: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Width-W batched beam search over the KV caches ([nl, B·W, T, D],
    beams of lane i in rows [i·W, (i+1)·W)). Each step renormalises
    log-probabilities over the allowed items, expands W·V candidates, keeps
    the best W and reorders the caches by parent beam; done beams carry
    their score on PAD, dead beams on EOS. ``beam_width=1`` gives greedy's
    tokens. Returns the best beam's buffer [B, max_len]."""
    with span("regen.encode"):
        generator.eval()
        b, w = src.shape[0], beam_width
        vocab = generator.num_items + 2
        nl, d = generator.num_layers, generator.embed_dim
        mem_k, mem_v = generator.decode_state(src, condition)
        mem_k = mem_k.repeat_interleave(w, dim=1)
        mem_v = mem_v.repeat_interleave(w, dim=1)
        memory_valid = (src != 0).repeat_interleave(w, dim=0)
        in_src = _source_mask(src, vocab)[:, None]
        u = _lane_draws(gamma, draws, rng, max_len - 1, b, src.device)
        cache_k, cache_v = _caches(generator, b * w, max_len, mem_k)
        buf, emitted, done = _start(src, generator, max_len, lanes=(w,))
        # identical SOS prefixes: only beam 0 starts live
        scores = torch.full((b, w), NEG, device=src.device)
        scores[:, 0] = 0.0
        rows = torch.arange(b, device=src.device)[:, None]
        beams = torch.arange(w, device=src.device)[None, :]
    for i in range(max_len - 1):
        with span("regen.position"):
            logits = generator.cached_decode_step(buf[:, :, i].reshape(b * w), i, cache_k,
                                                  cache_v, mem_k, mem_v,
                                                  memory_valid).reshape(b, w, vocab)
            allowed = _allowed(in_src, emitted, u, gamma, i)
            dead = ~allowed.any(dim=-1)
            logp = F.log_softmax(torch.where(allowed, logits.float(), NEG), dim=-1)
            cand = scores[..., None] + torch.where(allowed, logp, NEG)
            forced_tok = torch.where(done, 0, generator.eos)
            forced_cand = torch.where(F.one_hot(forced_tok, vocab).bool(), scores[..., None],
                                      NEG)
            cand = torch.where((done | dead)[..., None], forced_cand, cand)
            scores, top_idx = top_k_stable(cand.reshape(b, w * vocab), w)
            parent = top_idx // vocab
            nxt = top_idx % vocab
            buf, emitted, done = buf[rows, parent], emitted[rows, parent], done[rows, parent]
            cache_k = cache_k.reshape(nl, b, w, max_len, d)[:, rows, parent].reshape(
                nl, b * w, max_len, d)
            cache_v = cache_v.reshape(nl, b, w, max_len, d)[:, rows, parent].reshape(
                nl, b * w, max_len, d)
            buf[:, :, i + 1] = nxt
            emitted[rows, beams, nxt] = True
            done |= nxt == generator.eos
    best = scores.argmax(dim=1)
    return buf[torch.arange(b, device=src.device), best]


def frame_sources(sequences: List[List[int]], generator: Generator, max_src: int = 52) -> np.ndarray:
    """Raw item sequences -> SOS/EOS-framed, 0-padded int64 [n, max_src]."""
    out = np.zeros((len(sequences), max_src), np.int64)
    for i, s in enumerate(sequences):
        framed = [generator.sos] + list(s)[: max_src - 2] + [generator.eos]
        out[i, : len(framed)] = framed
    return out


def decode_dataset(
    generator: Generator,
    sequences: List[List[int]],  # raw item sequences (no SOS/EOS)
    k_conditions: int,
    batch_size: int = 1024,
    max_len: int = 25,
    max_src: int = 52,
    gamma: float = 0.0,
    seed: int = 0,
    use_kv_cache: bool = True,
    precision: str = "fp32",
    beam_width: int = 1,
    mesh_plan: Optional[MeshPlan] = None,
) -> List[List[int]]:
    """Decode every sequence under every condition, on the device of the
    generator's weights; the regenerated item lists (SOS/EOS stripped), in
    the order condition-major, then sequence. The last chunk of each pass is
    padded to ``batch_size`` with all-zero sources, which the encoder sees
    as fully masked rows. ``precision='bf16'`` decodes with a bfloat16 copy
    of the weights (argmax may flip on near-tied logits; opt-in). Under
    ``mesh_plan`` every ``data`` rank decodes its share of each batch's
    lanes (``batch_size`` padded up to a multiple of the axis) and returns
    the same list.

    On a CUDA device the greedy cached path (``beam_width=1``,
    ``use_kv_cache=True``) replays a CUDA graph a batch
    (:class:`_DecodeGraphs`, kept for the generator across calls): a
    batch shape's first batch runs eagerly, its second is captured, and
    from then on each batch is one replay. The γ draws are drawn outside
    the graph, as on every other path, and the all-gather stays outside
    it; the tokens are the eager path's to the bit."""
    if precision == "bf16":
        generator = copy.deepcopy(generator).to(torch.bfloat16)
    elif precision != "fp32":
        raise ValueError(f"precision must be fp32 or bf16, got {precision!r}")
    device = generator.item_embedding.weight.device
    data = (mesh_plan or MeshPlan()).axis(DATA_AXIS)
    lanes = -(-batch_size // data.size) * data.size
    rng = torch.Generator(device=device).manual_seed(seed)
    graphs = (_graphs_of(generator, device)
              if device.type == "cuda" and beam_width == 1 and use_kv_cache else None)
    src_all = frame_sources(sequences, generator, max_src)
    n = len(sequences)
    outputs: List[List[int]] = []
    for cond in range(k_conditions):
        for start in range(0, n, batch_size):
            chunk = src_all[start : start + batch_size]
            real = len(chunk)
            if real < lanes:
                chunk = np.concatenate([chunk, np.zeros((lanes - real, max_src), np.int64)])
            src = data.chunk(torch.from_numpy(chunk), 0).to(device)
            condition = torch.full((src.shape[0],), cond, dtype=torch.long, device=device)
            # the whole batch's draws on every rank, this rank's lanes kept
            draws = _lane_draws(gamma, None, rng, max_len - 1, lanes, device)
            if draws is not None:
                draws = data.chunk(draws, 1)
            if beam_width > 1:
                buf = beam_decode_batch_cached(generator, src, condition, max_len, gamma,
                                               beam_width, draws=draws)
            elif graphs is not None:
                buf = graphs.decode(generator, src, condition, max_len, gamma, draws)
            else:
                fn = greedy_decode_batch_cached if use_kv_cache else greedy_decode_batch
                buf = fn(generator, src, condition, max_len, gamma, draws=draws)
            with span("regen.collect"):
                buf = all_gather(buf, data, dim=0)
                body = buf[:real, 1:].cpu().numpy()  # skip SOS
                stop = (body == generator.eos) | (body == 0)
                first = np.where(stop.any(1), stop.argmax(1), body.shape[1])
                outputs.extend(body[i, : first[i]].tolist() for i in range(real))
    return outputs


def regenerated_rows(decoded: List[List[int]], max_seq_len: int = 50) -> List[list]:
    """Deduplicate decoded sequences and pack them as training rows
    ``[user_id=1, history, next-item targets, seqlen, label, domain]``.

    The label is all ones over ``max_seq_len``, padding included, as the
    JAX package writes it (``dr4sr_tpu/regen/decode.py:395``), where pattern
    rows (``pipeline.pattern_rows``) carry ones then zeros. Training reads
    only the targets' nonzero positions, so the two agree there; anything
    that reads ``label`` past ``seqlen`` would see the difference. The port
    keeps the reference's rows as they are."""
    rows = []
    for seq in sorted({tuple(seq) for seq in decoded if seq}):
        seq = list(seq)
        hist = seq[:-1]
        seq_len = min(len(hist), max_seq_len)
        if seq_len == 0:
            continue

        def fit(s):
            return s[-max_seq_len:] if len(s) > max_seq_len else s + [0] * (max_seq_len - len(s))

        rows.append([1, fit(hist), fit(seq[1:]), seq_len, [1] * max_seq_len, [0] * max_seq_len])
    return rows
