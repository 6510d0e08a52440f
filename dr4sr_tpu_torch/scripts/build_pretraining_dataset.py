"""Stage 1: mine patterns and build (sequence, pattern) pairs.

    python -m dr4sr_tpu_torch.scripts.build_pretraining_dataset \\
        --root_path dataset/amazon-toys/toy --alpha 5 --beta 2 [--n_jobs 0]

Reads ``seq2pat_data.npz`` (or the reference's ``.pth``) and ``train``;
writes ``patterns.npz`` (pattern rows, then the original train rows) and
``seq-pat-pair.pkl``. Host work only (the C++ miner), so no ``--cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
from typing import List, Optional

import numpy as np

from dr4sr_tpu_torch.data.dataset import RowData, load_rows, rows_from_lists
from dr4sr_tpu_torch.regen.pipeline import build_pretraining_dataset
from dr4sr_tpu_torch.serialization import load_with_numpy


def load_seq2pat(root: str) -> List[List[int]]:
    """The mining corpus of a domain: ``seq2pat_data.npz`` (flat + offsets)
    or the reference's ``seq2pat_data.pth`` (a list of item lists)."""
    npz = os.path.join(root, "seq2pat_data.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            flat, offsets = z["flat"], z["offsets"]
        return [flat[offsets[i] : offsets[i + 1]].tolist() for i in range(len(offsets) - 1)]
    pth = os.path.join(root, "seq2pat_data.pth")
    return [[int(x) for x in s] for s in load_with_numpy(pth)]


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m dr4sr_tpu_torch.scripts.build_pretraining_dataset")
    parser.add_argument("--root_path", type=str, required=True)
    parser.add_argument("--alpha", type=int, default=5, help="max pattern span")
    parser.add_argument("--beta", type=int, default=2, help="min frequency")
    parser.add_argument("--n_jobs", type=int, default=0)
    parser.add_argument("--max_seq_len", type=int, default=50)
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--patterns_out", type=str, default="patterns",
                        help="basename (no .npz) for the pattern-rows output")
    parser.add_argument("--pairs_out", type=str, default="seq-pat-pair.pkl")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    sequences = load_seq2pat(args.root_path)
    print(f"loaded {len(sequences)} seq2pat sequences")
    train = load_rows(os.path.join(args.root_path, "train"), True, args.max_seq_len)
    pat_rows, pairs = build_pretraining_dataset(sequences, train, alpha=args.alpha,
                                                beta=args.beta, n_jobs=args.n_jobs,
                                                seed=args.seed)
    combined = RowData.concat([rows_from_lists(pat_rows, True, args.max_seq_len), train])
    combined.save_npz(os.path.join(args.root_path, args.patterns_out + ".npz"))
    with open(os.path.join(args.root_path, args.pairs_out), "wb") as f:
        pickle.dump(pairs, f)
    print(f"wrote {len(pat_rows)} pattern rows + {len(pairs)} pairs")


if __name__ == "__main__":
    main()
