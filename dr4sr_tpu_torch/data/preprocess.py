"""Dataset preprocessing (port of ``dr4sr_tpu/data/preprocess.py``, the
script equivalent of the reference notebooks).

The split protocol of ``dataset/preprocess_amazon.ipynb`` (cells 9-24) /
``preprocess_yelp.ipynb``:

* iterative 5-core filtering on users and items (:func:`core_filter`);
* factorize ids with PAD=0, ids starting at 1 (:func:`factorize_ids`);
* per user sequence (last ``max_seq_len`` kept): test = predict the last
  item from ``seq[:-1]``; val = the second-last from ``seq[:-2]``; train =
  history ``seq[:-3]`` with per-position next-item targets
  ``seq[-len-2:-2]`` and label ``[1]*len``, post-padded to ``max_seq_len``
  (:func:`build_splits`);
* ``seq2pat`` input = each user's items minus the val/test items.

:func:`resplit_sequences` applies the same leave-last-out protocol to raw
per-user sequences (a ``seq2pat_data`` file). pandas is imported only by
:func:`factorize_ids` (and by the preprocessing CLI's CSV and JSON modes).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from dr4sr_tpu_torch.data.dataset import RowData

PAD = 0


def core_filter(df, user_threshold: int = 5, item_threshold: int = 5):
    """Iterative k-core filtering (notebook cell 9)."""
    while True:
        n = len(df)
        df = df[df["user_id"].map(df["user_id"].value_counts()) >= user_threshold]
        df = df[df["item_id"].map(df["item_id"].value_counts()) >= item_threshold]
        if len(df) == n:
            break
    return df


def factorize_ids(df):
    """Dense ids with PAD=0 (notebook cell 12). Returns df, num_users, num_items."""
    import pandas as pd

    user_codes, user_tokens = pd.factorize(df["user_id"])
    item_codes, item_tokens = pd.factorize(df["item_id"])
    df = df.copy()
    df["user_id"] = user_codes + 1
    df["item_id"] = item_codes + 1
    return df, len(user_tokens) + 1, len(item_tokens) + 1


def _truncate_or_pad(seq: Sequence[int], max_seq_len: int) -> Tuple[List[int], int]:
    seq = list(seq)
    if len(seq) > max_seq_len:
        return seq[-max_seq_len:], max_seq_len
    return seq + [PAD] * (max_seq_len - len(seq)), len(seq)


def _pack(rows, max_seq_len: int, domain_idx: int, is_train: bool) -> RowData:
    m = len(rows)
    target_shape = (m, max_seq_len) if is_train else (m,)
    out = RowData(
        user_id=np.zeros(m, np.int32),
        in_item_id=np.zeros((m, max_seq_len), np.int32),
        item_id=np.zeros(target_shape, np.int32),
        seqlen=np.zeros(m, np.int32),
        label=np.zeros(target_shape, np.float32) if is_train else np.ones(m, np.float32),
        domain_id=np.full(m, domain_idx, np.int32),
    )
    for i, (u, h, t, n) in enumerate(rows):
        out.user_id[i] = u
        out.in_item_id[i] = h
        out.item_id[i] = t
        out.seqlen[i] = n
        if is_train:
            out.label[i, :n] = 1.0
    if not is_train:
        out.user_hist = out.in_item_id.copy()
    return out


def build_splits(
    user_seqs: Dict[int, List[int]], max_seq_len: int, domain_idx: int = 0
) -> Tuple[RowData, RowData, RowData]:
    """Leave-last-out splits from per-user item sequences (notebook cell 20).
    Users with fewer than 3 items are dropped; users whose train history
    would be empty are dropped from train only."""
    train, val, test = [], [], []
    for user_id, seq in user_seqs.items():
        seq = list(seq)[-max_seq_len:]
        if len(seq) < 3:
            continue
        hist, n = _truncate_or_pad(seq[:-1], max_seq_len)
        test.append((user_id, hist, seq[-1], n))
        hist, n = _truncate_or_pad(seq[:-2], max_seq_len)
        val.append((user_id, hist, seq[-2], n))
        hist, n = _truncate_or_pad(seq[:-3], max_seq_len)
        if n == 0:
            continue
        target, _ = _truncate_or_pad(seq[-n - 2 : -2], max_seq_len)
        train.append((user_id, hist, target, n))
    return (_pack(train, max_seq_len, domain_idx, True),
            _pack(val, max_seq_len, domain_idx, False),
            _pack(test, max_seq_len, domain_idx, False))


def seq2pat_sequences(user_seqs: Dict[int, List[int]]) -> List[List[int]]:
    """Pattern-mining input: per-user sequence minus val/test (cell 19)."""
    return [list(seq)[:-2] for seq in user_seqs.values() if len(seq) > 2]


def save_domain(
    out_dir: str,
    train: RowData,
    val: RowData,
    test: RowData,
    num_users: int,
    num_items: int,
) -> None:
    """Write the native on-disk layout for one domain directory."""
    os.makedirs(out_dir, exist_ok=True)
    train.save_npz(os.path.join(out_dir, "train.npz"))
    val.save_npz(os.path.join(out_dir, "val.npz"))
    test.save_npz(os.path.join(out_dir, "test.npz"))
    domain_items = np.unique(np.concatenate([train.in_item_id.ravel(), train.item_id.ravel(),
                                             val.item_id.ravel(), test.item_id.ravel()]))
    domain_users = np.unique(np.concatenate([train.user_id, val.user_id, test.user_id]))
    np.savez(
        os.path.join(out_dir, "meta.npz"),
        num_users=num_users,
        num_items=num_items,
        domain_items=domain_items[domain_items != PAD],
        domain_users=domain_users[domain_users != PAD],
    )


def resplit_sequences(
    sequences: List[List[int]], max_seq_len: int = 50, domain_idx: int = 0
) -> Tuple[RowData, RowData, RowData, int, int]:
    """Apply the leave-last-out protocol to raw sequences (1-indexed users).

    Returns (train, val, test, num_users, num_items).
    """
    user_seqs = {i + 1: s for i, s in enumerate(sequences) if len(s) >= 3}
    num_users = len(sequences) + 1
    num_items = int(max(max(s) for s in sequences if s)) + 1
    tr, va, te = build_splits(user_seqs, max_seq_len, domain_idx)
    return tr, va, te, num_users, num_items
