"""The whole regeneration pipeline in one process, no intermediate files:
mine → pretrain the regenerator → hybrid decode → train the target model on
the assembled rows, which go to the trainer in memory.

    python -m dr4sr_tpu_torch.scripts.fused_pipeline --dataset amazon-toys \\
        [--root dataset] [--regen-epochs 40] [--train-epochs N] [--cpu]

Prints one JSON line: seconds per stage, total wall, test metrics. Configs
are read from ``configs/`` (PyYAML).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import List, Optional

from dr4sr_tpu_torch.config import load_config
from dr4sr_tpu_torch.data.dataset import RowData, prepare_datasets
from dr4sr_tpu_torch.regen.pipeline import (
    assemble_train_regen,
    build_pretraining_dataset,
    hybrid_inference,
    pretrain_regenerator,
    train_sequences_from_rows,
)
from dr4sr_tpu_torch.scripts.build_pretraining_dataset import load_seq2pat
from dr4sr_tpu_torch.train.trainer import Trainer


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m dr4sr_tpu_torch.scripts.fused_pipeline")
    parser.add_argument("--dataset", type=str, default="amazon-toys")
    parser.add_argument("--root", type=str, default="dataset")
    parser.add_argument("--model", type=str, default="SASRec")
    parser.add_argument("--alpha", type=int, default=5)
    parser.add_argument("--beta", type=int, default=2)
    parser.add_argument("--K", type=int, default=5)
    parser.add_argument("--regen-epochs", type=int, default=40)
    parser.add_argument("--train-epochs", type=int, default=None)
    parser.add_argument("--gamma", type=float, default=0.0)
    parser.add_argument("--max-len", type=int, default=25)
    parser.add_argument("--decode-batch", type=int, default=1024)
    parser.add_argument("--original-repeat", type=int, default=1)
    parser.add_argument("--min-regen-len", type=int, default=2)
    parser.add_argument("--entropy-weight", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = "cpu" if args.cpu else "cuda"

    t_all = time.perf_counter()
    timings = {}
    config = load_config(args.model, args.dataset)
    config["data"]["train_file"] = ""  # the base rows; the regenerated ones join in memory
    if args.train_epochs is not None:
        config["train"]["epochs"] = args.train_epochs
    config["train"]["seed"] = args.seed
    train_ds, val_ds, test_ds = prepare_datasets(config, root=args.root)
    domain_root = os.path.join(args.root, args.dataset, train_ds.domain_name_list[0])
    max_seq_len = train_ds.max_seq_len

    t0 = time.perf_counter()
    if any(os.path.exists(os.path.join(domain_root, f"seq2pat_data.{ext}"))
           for ext in ("npz", "pth")):
        sequences = load_seq2pat(domain_root)
    else:  # no bundled mining corpus: mine the train rows
        sequences = train_sequences_from_rows(train_ds.rows())
    pat_rows, pairs = build_pretraining_dataset(sequences, train_ds.rows(), alpha=args.alpha,
                                                beta=args.beta, seed=args.seed)
    timings["stage1_mine_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    generator, _ = pretrain_regenerator(pairs, train_ds.num_items, k=args.K,
                                        epochs=args.regen_epochs, seed=args.seed,
                                        entropy_weight=args.entropy_weight, device=device)
    timings["stage2_pretrain_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    regen_rows, stats = hybrid_inference(generator, train_ds.rows(), k_conditions=args.K,
                                         batch_size=args.decode_batch, max_len=args.max_len,
                                         gamma=args.gamma, seed=args.seed, device=device)
    if args.min_regen_len > 2:
        regen_rows = [r for r in regen_rows if r[3] >= args.min_regen_len - 1]
    timings["stage3_decode_s"] = time.perf_counter() - t0
    timings["decode_seqs_per_sec"] = stats["seqs_per_sec"]

    base = RowData.concat([train_ds.rows()] * args.original_repeat)
    combined = assemble_train_regen(base, pat_rows, regen_rows, max_seq_len)
    train_ds.data = combined

    t0 = time.perf_counter()
    trainer = Trainer(config, (train_ds, val_ds, test_ds), device=device)
    trainer.fit()
    test = trainer.evaluate()
    timings["stage4_train_s"] = time.perf_counter() - t0

    out = {"fused": True, "dataset": args.dataset, "model": args.model, "device": device,
           "train_rows_fused": len(combined), "regen_rows": len(regen_rows),
           "pattern_rows": len(pat_rows), "total_wall_s": time.perf_counter() - t_all,
           **timings, "test": {k: float(v) for k, v in test.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
