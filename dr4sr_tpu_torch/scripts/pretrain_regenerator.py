"""Stage 2: pretrain the regenerator on the pairs of stage 1.

    python -m dr4sr_tpu_torch.scripts.pretrain_regenerator \\
        --root_path dataset/amazon-toys/toy --K 5 --epochs 40 [--cpu]

``num_items`` comes from the domain's ``meta.npz`` (or ``inter.csv``); the
item table is seeded from ``--embedding`` (default
``<root>/pre-trained_embedding.ckpt`` if it exists): a SASRec checkpoint of
this package or of the JAX package, or the reference's ``.ckpt``. Writes the
regenerator checkpoint (``train/checkpoint.save_regenerator``).
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
from typing import List, Optional

import numpy as np

from dr4sr_tpu_torch.data.dataset import _read_inter_csv
from dr4sr_tpu_torch.regen.pipeline import pretrain_regenerator
from dr4sr_tpu_torch.train.checkpoint import load_item_embedding, save_regenerator


def domain_num_items(root: str) -> int:
    meta = os.path.join(root, "meta.npz")
    if os.path.exists(meta):
        with np.load(meta) as z:
            return int(z["num_items"])
    _, items = _read_inter_csv(os.path.join(root, "inter.csv"))
    return int(items.max()) + 1


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m dr4sr_tpu_torch.scripts.pretrain_regenerator")
    parser.add_argument("--root_path", type=str, required=True)
    parser.add_argument("--output_name", type=str, default="regenerator.pt")
    parser.add_argument("--pairs_name", type=str, default="seq-pat-pair.pkl")
    parser.add_argument("--K", type=int, default=5)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--embedding", type=str, default=None,
                        help="path to a pre-trained embedding ckpt")
    parser.add_argument("--entropy_weight", type=float, default=1.0,
                        help="condition-entropy coefficient; +1 matches the reference "
                             "(penalize entropy -> peaked conditions)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    # the pairs file is stage 1's own output (a pickle of int lists)
    with open(os.path.join(args.root_path, args.pairs_name), "rb") as f:
        pairs = pickle.load(f)
    num_items = domain_num_items(args.root_path)
    print(f"{len(pairs)} pairs, num_items={num_items}")
    emb = None
    emb_path = args.embedding or os.path.join(args.root_path, "pre-trained_embedding.ckpt")
    if os.path.exists(emb_path):
        emb = load_item_embedding(emb_path)
        print(f"loaded pre-trained embedding {None if emb is None else emb.shape}")
    module, _ = pretrain_regenerator(pairs, num_items, k=args.K, epochs=args.epochs,
                                     batch_size=args.batch_size, seed=args.seed,
                                     pretrained_embedding=emb,
                                     entropy_weight=args.entropy_weight,
                                     device="cpu" if args.cpu else "cuda")
    out = os.path.join(args.root_path, args.output_name)
    save_regenerator(out, module)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
