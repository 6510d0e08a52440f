"""Preprocess raw data into the on-disk dataset layout (port of
``scripts/preprocess.py``, the script equivalent of the reference notebooks).

Four modes:

* ``--raw-csv``: full protocol from a ratings CSV (user,item,rating,ts) —
  5-core filter, factorize, leave-last-out split (``preprocess_amazon.ipynb``).
* ``--yelp-csv``: the yelp protocol (``preprocess_yelp.ipynb`` cells 4-9):
  a headered 3-column CSV (user_id,item_id,timestamp), same 5-core filter +
  split, no rating column.
* ``--yelp-json``: raw Yelp academic ``review.json`` (JSON lines with
  ``user_id``/``business_id``/``date``), converted to the 3-column frame and
  then run through the same protocol.
* ``--from-seq2pat``: rebuild train/val/test from a ``seq2pat_data.pth``
  (read with ``weights_only=True``, numpy's classes allowed) or ``.npz``
  (per-user sequences) with the same leave-last-out protocol.

The first three need pandas; ``--from-seq2pat`` needs numpy only. Usage:

  python -m dr4sr_tpu_torch.scripts.preprocess \\
      --from-seq2pat dataset/amazon-toys/toy/seq2pat_data.npz --out dataset/amazon-toys/toy
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from dr4sr_tpu_torch.data.preprocess import (
    build_splits,
    core_filter,
    factorize_ids,
    resplit_sequences,
    save_domain,
    seq2pat_sequences,
)
from dr4sr_tpu_torch.serialization import load_with_numpy


def load_sequences(path: str):
    if path.endswith(".pth"):
        return load_with_numpy(path)
    with np.load(path) as z:
        flat, offsets = z["flat"], z["offsets"]
    return [flat[offsets[i] : offsets[i + 1]].tolist() for i in range(len(offsets) - 1)]


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m dr4sr_tpu_torch.scripts.preprocess")
    parser.add_argument("--raw-csv", type=str, default=None)
    parser.add_argument("--yelp-csv", type=str, default=None)
    parser.add_argument("--yelp-json", type=str, default=None)
    parser.add_argument("--from-seq2pat", type=str, default=None)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--max-seq-len", type=int, default=50)
    parser.add_argument("--user-threshold", type=int, default=5)
    parser.add_argument("--item-threshold", type=int, default=5)
    parser.add_argument("--domain-idx", type=int, default=0)
    args = parser.parse_args(argv)

    df = None
    if args.raw_csv:
        import pandas as pd

        df = pd.read_csv(args.raw_csv, header=None)
        df.columns = ["user_id", "item_id", "rating", "timestamp"]
    elif args.yelp_csv:
        import pandas as pd

        df = pd.read_csv(args.yelp_csv)  # headered, per the yelp notebook
        df = df.iloc[:, :3]
        df.columns = ["user_id", "item_id", "timestamp"]
    elif args.yelp_json:
        import pandas as pd

        rows = []
        with open(args.yelp_json) as f:
            for line in f:
                r = json.loads(line)
                rows.append((r["user_id"], r["business_id"], r["date"]))
        df = pd.DataFrame(rows, columns=["user_id", "item_id", "timestamp"])

    if df is not None:
        df = core_filter(df, args.user_threshold, args.item_threshold)
        df, num_users, num_items = factorize_ids(df)
        df = df.sort_values(by=["user_id", "timestamp"])
        user_seqs = df.groupby("user_id")["item_id"].apply(list).to_dict()
        train, val, test = build_splits(user_seqs, args.max_seq_len, args.domain_idx)
        seqs = seq2pat_sequences(user_seqs)
    elif args.from_seq2pat:
        raw = load_sequences(args.from_seq2pat)
        train, val, test, num_users, num_items = resplit_sequences(
            [list(s) for s in raw], args.max_seq_len, args.domain_idx
        )
        # re-derive seq2pat input under the new split (train-visible part)
        seqs = [list(s)[:-2] for s in raw if len(s) >= 3]
    else:
        parser.error("one of --raw-csv / --yelp-csv / --yelp-json / "
                     "--from-seq2pat is required")

    save_domain(args.out, train, val, test, num_users, num_items)
    offsets = np.cumsum([0] + [len(s) for s in seqs]).astype(np.int64)
    flat = (np.concatenate([np.asarray(s, np.int32) for s in seqs]) if seqs
            else np.zeros(0, np.int32))
    np.savez(os.path.join(args.out, "seq2pat_data.npz"), flat=flat, offsets=offsets)
    print(
        f"wrote {args.out}: {len(train)} train / {len(val)} val / {len(test)} test rows, "
        f"{num_users} users, {num_items} items"
    )


if __name__ == "__main__":
    main()
