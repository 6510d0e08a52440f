"""The leave-last-out split and the on-disk layout of one domain.

Port of ``dr4sr_tpu/data/preprocess.py:57-161``, the part the synthetic
writer needs (the 5-core filter and id factorisation of the raw-data
notebooks wait for the preprocessing scripts):

* per user sequence (last ``max_seq_len`` kept): test = predict the last
  item from ``seq[:-1]``; val = the second-last from ``seq[:-2]``; train =
  history ``seq[:-3]`` with per-position next-item targets
  ``seq[-len-2:-2]`` and label ``[1]*len``, post-padded to ``max_seq_len``;
* ``seq2pat`` input = each user's items minus the val/test items.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from dr4sr_tpu_torch.data.dataset import RowData

PAD = 0


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
