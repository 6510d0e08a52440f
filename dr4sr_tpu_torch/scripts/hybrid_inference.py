"""Stage 3: batched hybrid inference, then ``train_regen``.

    python -m dr4sr_tpu_torch.scripts.hybrid_inference \\
        --root_path dataset/amazon-toys/toy --ckpt_name regenerator.pt --K 5 [--cpu]

Decodes every training sequence under every condition with the regenerator
checkpoint (this package's, or a JAX regenerator msgpack), deduplicates the
results into rows and writes ``<out_name>.npz``: stage 1's ``patterns.npz``
(pattern rows + original rows) when it exists and ``--no_patterns`` is not
given, else the original rows; then the regenerated rows; then
``--original_repeat - 1`` more copies of the original rows. After it,
``python -m dr4sr_tpu_torch.run -m SASRec -d <dataset>`` trains on it
through the dataset config's ``train_file: '_regen'``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
from typing import List, Optional

from dr4sr_tpu_torch.data.dataset import RowData, load_rows, rows_from_lists
from dr4sr_tpu_torch.regen.pipeline import assemble_train_regen, hybrid_inference
from dr4sr_tpu_torch.scripts.pretrain_regenerator import domain_num_items
from dr4sr_tpu_torch.train.checkpoint import load_regenerator


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m dr4sr_tpu_torch.scripts.hybrid_inference")
    parser.add_argument("--root_path", type=str, required=True)
    parser.add_argument("--ckpt_name", type=str, default="regenerator.pt")
    parser.add_argument("--K", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=1024)
    parser.add_argument("--max_len", type=int, default=25)
    parser.add_argument("--gamma", type=float, default=0.0,
                        help="per-step probability of generative masking")
    parser.add_argument("--max_seq_len", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_name", type=str, default="train_regen",
                        help="basename (no .npz) of the assembled train file")
    parser.add_argument("--patterns_name", type=str, default="patterns")
    parser.add_argument("--no_patterns", action="store_true",
                        help="assemble original+regen only (drop pattern rows)")
    parser.add_argument("--beam_width", type=int, default=1,
                        help="beam search width (1 = greedy, the reference's behavior)")
    parser.add_argument("--regen_cache", type=str, default=None,
                        help="pickle path caching the regenerated rows; decode is skipped "
                             "when it exists (and was decoded with the same flags)")
    parser.add_argument("--original_repeat", type=int, default=1,
                        help="include the original train rows this many times")
    parser.add_argument("--min_regen_len", type=int, default=2,
                        help="drop regenerated sequences shorter than this many items "
                             "(pattern rows are unaffected)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    num_items = domain_num_items(args.root_path)
    device = "cpu" if args.cpu else "cuda"
    generator = load_regenerator(os.path.join(args.root_path, args.ckpt_name), device=device)
    if (generator.num_items, generator.k) != (num_items, args.K):
        raise SystemExit(f"{args.ckpt_name} has num_items={generator.num_items}, "
                         f"K={generator.k}; the domain has {num_items} items, --K is {args.K}")
    train = load_rows(os.path.join(args.root_path, "train"), True, args.max_seq_len)

    # decode-affecting flags; a cache hit is valid only if they match
    decode_params = {"ckpt_name": args.ckpt_name, "K": args.K, "max_len": args.max_len,
                     "gamma": args.gamma, "seed": args.seed}
    if args.beam_width != 1:
        decode_params["beam_width"] = args.beam_width
    sidecar = args.regen_cache + ".params.json" if args.regen_cache else None
    if args.regen_cache and os.path.exists(args.regen_cache):
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                cached_params = json.load(f)
            if cached_params != decode_params:
                raise SystemExit(f"--regen_cache {args.regen_cache} was decoded with "
                                 f"{cached_params}, current flags are {decode_params}; "
                                 "refusing to mix: delete the cache or change its path")
        else:
            print(f"warning: {args.regen_cache} has no params sidecar; trusting the filename")
        # the cache is this stage's own output (a pickle of row lists)
        with open(args.regen_cache, "rb") as f:
            regen_rows = pickle.load(f)
        stats = {"cached": True, "unique_regenerated": len(regen_rows)}
    else:
        regen_rows, stats = hybrid_inference(
            generator, train, k_conditions=args.K, batch_size=args.batch_size,
            max_len=args.max_len, gamma=args.gamma, seed=args.seed,
            beam_width=args.beam_width, device=device)
        if args.regen_cache:
            with open(args.regen_cache, "wb") as f:
                pickle.dump(regen_rows, f)
            with open(sidecar, "w") as f:
                json.dump(decode_params, f)

    if args.min_regen_len > 2:
        # rows are [user_id, seq, target, seqlen, label, domain]; items = seqlen + 1
        kept = [r for r in regen_rows if int(r[3]) + 1 >= args.min_regen_len]
        stats["regen_len_filtered"] = len(regen_rows) - len(kept)
        regen_rows = kept

    pat_path = os.path.join(args.root_path, args.patterns_name)
    if not args.no_patterns and os.path.exists(pat_path + ".npz"):
        patterns = load_rows(pat_path, True, args.max_seq_len)  # includes the original rows
        combined = RowData.concat([patterns, rows_from_lists(regen_rows, True, args.max_seq_len)])
    else:
        combined = assemble_train_regen(train, [], regen_rows, args.max_seq_len)
    if args.original_repeat > 1:
        combined = RowData.concat([combined] + [train] * (args.original_repeat - 1))
    combined.save_npz(os.path.join(args.root_path, args.out_name + ".npz"))
    print(f"wrote {args.out_name}.npz with {len(combined)} rows; stats={stats}")


if __name__ == "__main__":
    main()
