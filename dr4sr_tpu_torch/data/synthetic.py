"""Synthetic sequential-recommendation data (the port's own copy of
``dr4sr_tpu/data/synthetic.py``): Markov-chain user sequences with a
block-diagonal transition structure, so a working model beats random
ranking quickly. ``write_synthetic_dataset`` writes the same files as the
JAX writer; ``chip_smoke.py`` makes its request histories and its training
set with it.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from dr4sr_tpu_torch.data.preprocess import build_splits, save_domain, seq2pat_sequences


def markov_sequences(
    num_users: int = 200,
    num_items: int = 120,
    min_len: int = 5,
    max_len: int = 30,
    num_blocks: int = 4,
    stay_prob: float = 0.9,
    seed: int = 0,
) -> List[List[int]]:
    """Per-user item sequences from a block-structured markov chain.

    Item ids are 1..num_items-1 (0 is PAD).
    """
    rng = np.random.default_rng(seed)
    items = np.arange(1, num_items)
    blocks = np.array_split(items, num_blocks)
    seqs = []
    for _ in range(num_users):
        n = int(rng.integers(min_len, max_len + 1))
        b = int(rng.integers(num_blocks))
        seq = []
        cur = int(rng.choice(blocks[b]))
        for _ in range(n):
            seq.append(cur)
            if rng.random() < stay_prob:
                # walk within the block, biased to a ring structure
                blk = blocks[b]
                pos = int(np.searchsorted(blk, cur))
                cur = int(blk[(pos + 1) % len(blk)])
            else:
                b = int(rng.integers(num_blocks))
                cur = int(rng.choice(blocks[b]))
        seqs.append(seq)
    return seqs


def write_synthetic_dataset(
    root: str,
    name: str = "synthetic",
    domain: str = "syn",
    num_users: int = 200,
    num_items: int = 120,
    max_seq_len: int = 50,
    seed: int = 0,
) -> Dict[str, int]:
    """Materialize a full on-disk dataset (train/val/test/meta + seq2pat)."""
    seqs = markov_sequences(num_users=num_users, num_items=num_items, seed=seed)
    user_seqs = {i + 1: s for i, s in enumerate(seqs)}
    train, val, test = build_splits(user_seqs, max_seq_len)
    out_dir = os.path.join(root, name, domain)
    save_domain(out_dir, train, val, test, num_users + 1, num_items)
    # identical rows under the '_ori' suffix so configs with train_file='_ori' work
    train.save_npz(os.path.join(out_dir, "train_ori.npz"))
    np.savez(
        os.path.join(out_dir, "seq2pat_data.npz"),
        flat=np.concatenate([np.asarray(s, np.int32) for s in seq2pat_sequences(user_seqs)]),
        offsets=np.cumsum([0] + [len(s) - 2 for s in seqs if len(s) > 2]).astype(np.int64),
    )
    return {"num_users": num_users + 1, "num_items": num_items}


def synthetic_config(
    name: str = "synthetic",
    domain: str = "syn",
    max_seq_len: int = 50,
    model_name: str = "SASRec",
    train_file: str = "",
) -> dict:
    """A minimal in-memory config for the synthetic dataset."""
    return {
        "data": {
            "dataset": name,
            "domain_name_list": [domain],
            "max_seq_len": max_seq_len,
            "dataset_class": "general",
            "train_file": train_file,
        },
        "model": {
            "model": model_name,
            "embed_dim": 64,
            "loss_fn": "bce",
            "hidden_size": 128,
            "layer_num": 2,
            "head_num": 2,
            "dropout_rate": 0.5,
            "activation": "gelu",
            "layer_norm_eps": 1e-12,
        },
        "train": {
            "batch_size": 64,
            "early_stop_mode": "max",
            "early_stop_patience": 3,
            "epochs": 2,
            "optimizer": "adam",
            "learning_rate": 1e-3,
            "weight_decay": 0.0,
            "num_neg": 1,
            "seed": 2023,
        },
        "eval": {
            "batch_size": 128,
            "cutoff": [20, 10],
            "val_metrics": ["ndcg", "recall"],
            "test_metrics": ["ndcg", "recall"],
            "topk": 100,
            "save_path": "./saved/",
        },
    }
