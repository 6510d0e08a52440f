"""The benchmark's inputs, made from ``--seed``: amazon-toys-sized Markov data.

A frozen copy of the port's ``data/synthetic.py::markov_sequences`` chain
(four blocks of items, a ring walk inside a block kept with probability
0.9, else a jump to a random item of a random block), vectorised over the
users, at the counts a configuration gives: for amazon-toys after the
5-core filter (the S3-Rec and DR4SR tables) 19,412 users, 11,925 item rows
(ids 1..11,924; 0 is PAD) and 167,597 interactions, at least 5 a user.

The lengths are one fixed multiset, the same for every seed: a discretised
exponential tail above the minimum of 5, fitted so that the total is
exactly the configuration's (mean 8.634 at Toys'). The seed only says which user gets which
length and which items the walk visits, so every seed trains, serves and
decodes the same amount of work.

From the sequences, as the port's ``data/preprocess.py::build_splits``
lays them out (leave the last two out): the train rows (history
``seq[:-3]``, per-position targets ``seq[1:-2]``), the validation and test
rows, the stage-3 sources (``seq[:-2]``, the port's
``train_sequences_from_rows``) and the pretraining pairs (a source and an
ordered subsequence of it within a window of ``ALPHA`` positions, as a
mined pattern of span at most ``ALPHA`` is).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

MIN_LEN = 5
NUM_BLOCKS = 4
STAY_PROB = 0.9
ALPHA = 5  # a pattern's span, as stage 1 mines them (alpha = 5)


def lengths(num_users: int, num_interactions: int) -> np.ndarray:
    """The fixed multiset of sequence lengths, ascending: ``MIN_LEN`` plus
    the floor of evenly spaced quantiles of an exponential whose scale is
    fitted by bisection; the remainder of the total goes one each to the
    longest sequences."""
    u = (np.arange(num_users) + 0.5) / num_users
    tail = -np.log1p(-u)
    want = num_interactions - MIN_LEN * num_users
    lo, hi = 0.0, 64.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if np.floor(tail * mid).sum() > want:
            hi = mid
        else:
            lo = mid
    extra = np.floor(tail * lo).astype(np.int64)
    extra[len(extra) - (want - int(extra.sum())):] += 1
    return MIN_LEN + extra


def markov_sequences(seed: int, num_users: int, num_items: int,
                     num_interactions: int) -> List[np.ndarray]:
    """One int64 item sequence per user, from ``seed``; item ids 1 to
    ``num_items`` − 1."""
    rng = np.random.default_rng(seed)
    lens = rng.permutation(lengths(num_users, num_interactions))
    blocks = np.array_split(np.arange(1, num_items), NUM_BLOCKS)
    starts = np.array([b[0] for b in blocks])
    sizes = np.array([len(b) for b in blocks])
    n, t_max = num_users, int(lens.max())
    block = rng.integers(NUM_BLOCKS, size=n)
    cur = starts[block] + rng.integers(0, sizes[block])
    out = np.zeros((n, t_max), np.int64)
    for t in range(t_max):
        out[:, t] = cur
        stay = rng.random(n) < STAY_PROB
        jump_block = rng.integers(NUM_BLOCKS, size=n)
        jump_item = starts[jump_block] + (rng.random(n) * sizes[jump_block]).astype(np.int64)
        ring = starts[block] + (cur - starts[block] + 1) % sizes[block]
        cur = np.where(stay, ring, jump_item)
        block = np.where(stay, block, jump_block)
    return [out[i, : lens[i]] for i in range(n)]


def _right_pad(seqs: List[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        s = s[-width:]
        out[i, : len(s)] = s
    return out


def split_rows(seqs: List[np.ndarray], max_seq_len: int) -> Dict[str, Dict[str, np.ndarray]]:
    """Train, validation and test rows in the port's ``.npz`` layout
    (``data/dataset.py::load_rows``), as ``build_splits`` makes them."""
    seqs = [s[-max_seq_len:] for s in seqs]
    users = np.arange(1, len(seqs) + 1, dtype=np.int32)
    train_hist = [s[:-3] for s in seqs]
    train_tgt = [s[1:-2] for s in seqs]
    n_train = np.array([len(h) for h in train_hist], np.int32)
    in_item = _right_pad(train_hist, max_seq_len)
    label = (np.arange(max_seq_len)[None, :] < n_train[:, None]).astype(np.float32)
    out = {"train": {"user_id": users, "in_item_id": in_item,
                     "item_id": _right_pad(train_tgt, max_seq_len), "seqlen": n_train,
                     "label": label, "domain_id": np.zeros(len(seqs), np.int32)}}
    for phase, cut in (("val", 2), ("test", 1)):
        hist = _right_pad([s[:-cut] for s in seqs], max_seq_len)
        out[phase] = {"user_id": users, "in_item_id": hist,
                      "item_id": np.array([s[-cut] for s in seqs], np.int32),
                      "seqlen": np.array([len(s) - cut for s in seqs], np.int32),
                      "label": np.ones(len(seqs), np.float32),
                      "domain_id": np.zeros(len(seqs), np.int32), "user_hist": hist}
    return out


def write_dataset(root: str, name: str, domain: str, seqs: List[np.ndarray],
                  max_seq_len: int, num_items: int) -> None:
    """The rows and ``meta.npz`` under ``root/name/domain``, uncompressed."""
    out_dir = os.path.join(root, name, domain)
    os.makedirs(out_dir, exist_ok=True)
    rows = split_rows(seqs, max_seq_len)
    for phase, arrays in rows.items():
        np.savez(os.path.join(out_dir, f"{phase}.npz"), **arrays)
    items = np.unique(np.concatenate([s for s in seqs]))
    np.savez(os.path.join(out_dir, "meta.npz"), num_users=len(seqs) + 1, num_items=num_items,
             domain_items=items[items != 0],
             domain_users=np.arange(1, len(seqs) + 1, dtype=np.int64))


def regen_sources(seqs: List[np.ndarray]) -> List[List[int]]:
    """The stage-3 sources: every train sequence (``seq[:-2]``)."""
    return [s[:-2].tolist() for s in seqs]


def frame(rows: np.ndarray, lens: np.ndarray, width: int, sos: int, eos: int) -> np.ndarray:
    """Right-padded rows [n, w] of lengths ``lens`` as SOS/EOS-framed,
    0-padded int64 [n, width] (``regen/generator.py::frame_pairs``)."""
    n, w = rows.shape
    lens = np.minimum(lens, min(w, width - 2))
    out = np.zeros((n, width), np.int64)
    out[:, 0] = sos
    body = np.where(np.arange(w)[None, :] < lens[:, None], rows, 0)[:, : width - 2]
    out[:, 1: 1 + body.shape[1]] = body
    out[np.arange(n), lens + 1] = eos
    return out


def pretraining_pairs(seqs: List[np.ndarray], seed: int, num_items: int, num_pairs: int,
                      max_src: int, max_tgt: int) -> Dict[str, np.ndarray]:
    """``num_pairs`` framed (source, pattern) pairs: ``src`` [n, max_src],
    ``tgt`` [n, max_tgt] and ``tgt_len``. The count is split as evenly as it goes
    over the sources (at toys' counts 9 or 10 each; the seed says which); a pattern is 2 to
    5 positions, in order, of one window of at most ``ALPHA`` positions of
    its source."""
    rng = np.random.default_rng([seed, 1])
    sources = [s[:-2] for s in seqs]
    n_src = len(sources)
    per = np.full(n_src, num_pairs // n_src)
    per[: num_pairs - int(per.sum())] += 1
    which = np.repeat(rng.permutation(n_src), per)
    src_rows = _right_pad(sources, max_src - 2).astype(np.int64)[which]
    src_len = np.minimum(np.array([len(s) for s in sources])[which], max_src - 2)
    n = len(which)
    window = np.minimum(src_len, ALPHA)
    start = (rng.random(n) * (src_len - window + 1)).astype(np.int64)
    m = 2 + (rng.random(n) * (window - 1)).astype(np.int64)  # 2..window
    # m of the window's positions, in order: those of the m smallest random keys
    keys = rng.random((n, ALPHA))
    keys[np.arange(ALPHA)[None, :] >= window[:, None]] = 2.0
    chosen = np.argsort(np.argsort(keys, axis=1), axis=1) < m[:, None]
    offset = np.sort(np.where(chosen, np.arange(ALPHA)[None, :], ALPHA), axis=1)
    pos = np.minimum(start[:, None] + offset, src_rows.shape[1] - 1)
    pattern = np.where(offset < ALPHA, np.take_along_axis(src_rows, pos, axis=1), 0)
    sos, eos = num_items, num_items + 1
    return {"src": frame(src_rows, src_len, max_src, sos, eos),
            "tgt": frame(pattern, m, max_tgt, sos, eos),
            "tgt_len": (m + 2).astype(np.int64)}
