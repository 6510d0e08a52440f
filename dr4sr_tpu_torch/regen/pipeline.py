"""The regeneration pipeline as library functions.

Port of ``dr4sr_tpu/regen/pipeline.py``:

* stage 1, :func:`build_pretraining_dataset` — mine patterns from the
  seq2pat sequences (host C++, :mod:`dr4sr_tpu_torch.regen.miner`), turn
  them into training rows (:func:`pattern_rows`) and match (sequence,
  pattern) pairs;
* stage 2, :func:`pretrain_regenerator` — train the regenerator on the
  pairs: Adam (β = 0.9, 0.98; eps 1e-9) with optax's cosine decay over the
  whole step budget, the batch order of ``np.random.default_rng(seed)``
  with the JAX loop's wrap-around padding of the last batch, gumbel τ
  annealed ×0.995 a step down to 0.1;
* stage 3, :func:`hybrid_inference` — decode the training set under every
  condition (:mod:`dr4sr_tpu_torch.regen.decode`) into regenerated rows;
  :func:`assemble_train_regen` joins original, pattern and regenerated
  rows into ``train_regen``.

The CLIs in ``dr4sr_tpu_torch/scripts/`` are thin wrappers.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dr4sr_tpu_torch.data.dataset import RowData, rows_from_lists
from dr4sr_tpu_torch.regen.decode import decode_dataset, regenerated_rows
from dr4sr_tpu_torch.regen.generator import Generator, frame_pairs, generator_loss
from dr4sr_tpu_torch.regen.miner import match_pairs, mine_patterns

logger = logging.getLogger("dr4sr_tpu_torch")

TAU_DECAY = 0.995  # gumbel temperature, per step
TAU_FLOOR = 0.1


def torch_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it asks for CUDA and
    there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} asked for, but CUDA is not available")
    return device


# --------------------------------------------------------------------- stage 1
def pattern_rows(patterns: Sequence[Sequence[int]], max_seq_len: int = 50) -> List[list]:
    """Patterns as training rows (user_id 0 marks them): the distinct
    (pattern[:-1], pattern[1:]) pairs, sorted, label ones then zeros."""
    def fit(seq):
        seq = list(seq)
        return seq[-max_seq_len:] if len(seq) > max_seq_len else seq + [0] * (max_seq_len - len(seq))

    train_set = {tuple(fit(p[:-1]) + fit(p[1:])) for p in patterns}
    rows = []
    for packed in sorted(train_set):
        hist = list(packed[:max_seq_len])
        target = list(packed[max_seq_len:])
        seq_len = sum(1 for a in hist if a != 0)
        rows.append([0, hist, target, seq_len, [1] * seq_len + [0] * (max_seq_len - seq_len),
                     [0] * max_seq_len])
    return rows


def train_sequences_from_rows(rows: RowData) -> List[List[int]]:
    """Each training row's history plus its final target."""
    out = []
    for i in range(len(rows)):
        n = int(rows.seqlen[i])
        if n == 0:
            continue
        seq = rows.in_item_id[i][:n].tolist()
        seq.append(int(rows.item_id[i][n - 1]))
        out.append(seq)
    return out


def build_pretraining_dataset(
    seq2pat_sequences: List[List[int]],
    train_rows: RowData,
    alpha: int = 5,
    beta: int = 2,
    max_matches: int = 10,
    n_jobs: int = 0,
    seed: int = 2024,
) -> Tuple[List[list], List[Tuple[List[int], List[int]]]]:
    """(pattern training rows, (sequence, pattern) pairs): patterns of span
    at most ``alpha`` in at least ``beta`` sequences."""
    t0 = time.perf_counter()
    patterns, _ = mine_patterns(seq2pat_sequences, max_span=alpha, min_frequency=beta,
                                n_jobs=n_jobs)
    logger.info(f"mined {len(patterns)} patterns in {time.perf_counter() - t0:.1f}s")
    rows = pattern_rows(patterns, train_rows.in_item_id.shape[1])
    seq_list = train_sequences_from_rows(train_rows)
    t0 = time.perf_counter()
    matches = match_pairs(seq_list, patterns, max_matches=max_matches, seed=seed, n_jobs=n_jobs)
    pairs = [(seq, patterns[p]) for seq, idxs in zip(seq_list, matches) for p in idxs]
    logger.info(f"built {len(pairs)} sequence-pattern pairs in {time.perf_counter() - t0:.1f}s")
    return rows, pairs


# --------------------------------------------------------------------- stage 2
def cosine_decay(total_steps: int):
    """optax ``cosine_decay_schedule(1, total_steps)`` as a LambdaLR factor."""
    def factor(step: int) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * min(step, total_steps) / total_steps))

    return factor


def regen_optimizer(module: Generator, learning_rate: float, total_steps: int):
    """(Adam(β = 0.9, 0.98; eps 1e-9), its per-step cosine-decay LambdaLR)."""
    opt = torch.optim.Adam(module.parameters(), lr=learning_rate, betas=(0.9, 0.98), eps=1e-9)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(total_steps))


def batch_order(n: int, batch_size: int, epochs: int, seed: int) -> Iterator[np.ndarray]:
    """Row indices of every step: a ``default_rng(seed)`` permutation per
    epoch, the last batch padded by wrapping to its own start."""
    host_rng = np.random.default_rng(seed)
    steps = max(1, (n + batch_size - 1) // batch_size)
    for _ in range(epochs):
        order = host_rng.permutation(n)
        for b in range(steps):
            idx = order[b * batch_size : (b + 1) * batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, idx[: batch_size - len(idx)]])
            yield idx


def pretrain_step(
    module: Generator,
    optimizer: torch.optim.Optimizer,
    scheduler,
    src: torch.Tensor,  # [B, Ls]
    tgt: torch.Tensor,  # [B, Lt + 1]
    tgt_len: torch.Tensor,  # [B]
    tau: float,
    entropy_weight: float = 1.0,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One optimizer step in train mode: teacher-forced on ``tgt[:, :-1]``
    against ``tgt[:, 1:]``. Returns {loss, ce, entropy} (on the device)."""
    module.train()
    optimizer.zero_grad(set_to_none=True)
    logits, cond = module(src, tgt[:, :-1], tgt_len, tau, generator=generator, gumbel=gumbel)
    loss, aux = generator_loss(logits, tgt[:, 1:], cond, entropy_weight)
    loss.backward()
    optimizer.step()
    scheduler.step()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}


def pretrain_regenerator(
    pairs: Sequence[Tuple[List[int], List[int]]],
    num_items: int,
    k: int = 5,
    epochs: int = 40,
    batch_size: int = 256,
    learning_rate: float = 1e-3,
    seed: int = 2024,
    pretrained_embedding: Optional[np.ndarray] = None,
    entropy_weight: float = 1.0,
    device="cuda",
) -> Tuple[Generator, Dict[str, list]]:
    """Train a fresh regenerator on ``pairs``; returns (module, history with
    the CE of every step). Weights from ``seed`` (drawn on the CPU, so every
    device starts from the same), gumbel noise from a generator and dropout
    from the default one, both seeded ``seed + 1``. ``pretrained_embedding``
    seeds the catalog rows of the item table; SOS/EOS stay random."""
    device = torch_device(device)
    data = frame_pairs(pairs, num_items)
    n = len(data["src"])
    module = Generator(num_items, k=k, generator=torch.Generator().manual_seed(seed))
    if pretrained_embedding is not None:
        rows = min(pretrained_embedding.shape[0], num_items)
        with torch.no_grad():
            module.item_embedding.weight[:rows] = torch.as_tensor(pretrained_embedding[:rows])
    module.to(device)
    steps_per_epoch = max(1, (n + batch_size - 1) // batch_size)
    optimizer, scheduler = regen_optimizer(module, learning_rate, epochs * steps_per_epoch)
    gumbel_rng = torch.Generator(device=device).manual_seed(seed + 1)
    torch.manual_seed(seed + 1)
    arrays = {key: torch.from_numpy(data[key]).long() for key in ("src", "tgt", "tgt_len")}
    tau, history = 1.0, {"ce": []}
    t0 = time.perf_counter()
    for step, idx in enumerate(batch_order(n, batch_size, epochs, seed)):
        idx = torch.from_numpy(idx)
        out = pretrain_step(module, optimizer, scheduler,
                            *(arrays[key][idx].to(device) for key in ("src", "tgt", "tgt_len")),
                            tau, entropy_weight, generator=gumbel_rng)
        tau = max(tau * TAU_DECAY, TAU_FLOOR)
        history["ce"].append(float(out["ce"]))
        if (step + 1) % steps_per_epoch == 0:
            epoch_ce = history["ce"][-steps_per_epoch:]
            logger.info(f"regen epoch {(step + 1) // steps_per_epoch}/{epochs}: "
                        f"ce={sum(epoch_ce) / len(epoch_ce):.3f} tau={tau:.3f} "
                        f"({time.perf_counter() - t0:.1f}s)")
            t0 = time.perf_counter()
    return module, history


# --------------------------------------------------------------------- stage 3
def hybrid_inference(
    generator: Generator,
    train_rows: RowData,
    k_conditions: int = 5,
    batch_size: int = 1024,
    max_len: int = 25,
    gamma: float = 0.0,
    seed: int = 0,
    beam_width: int = 1,
    device="cuda",
) -> Tuple[List[list], Dict[str, float]]:
    """Decode the whole training set under every condition on ``device``
    (the generator is moved there); returns (regenerated rows, stats)."""
    generator.to(torch_device(device))
    sequences = train_sequences_from_rows(train_rows)
    t0 = time.perf_counter()
    decoded = decode_dataset(generator, sequences, k_conditions, batch_size=batch_size,
                             max_len=max_len, gamma=gamma, seed=seed, beam_width=beam_width)
    dt = time.perf_counter() - t0
    rows = regenerated_rows(decoded, train_rows.in_item_id.shape[1])
    stats = {
        "sequences_decoded": len(sequences) * k_conditions,
        "unique_regenerated": len(rows),
        "seconds": dt,
        "seqs_per_sec": len(sequences) * k_conditions / max(dt, 1e-9),
    }
    logger.info(f"hybrid inference: {stats}")
    return rows, stats


def assemble_train_regen(
    original_rows: RowData,
    pattern_rows_list: List[list],
    regen_rows_list: List[list],
    max_seq_len: int = 50,
) -> RowData:
    """train_regen = original rows, then pattern rows, then regenerated rows."""
    extra = rows_from_lists(pattern_rows_list + regen_rows_list, True, max_seq_len)
    return RowData.concat([original_rows, extra])
