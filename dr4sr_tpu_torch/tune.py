"""CLI: hyperparameter sweep with the port (the root ``tune.py``'s surface).

    python -m dr4sr_tpu_torch.tune -m SASRec -d amazon-toys [--root dataset]
        [--sweep sweep/sasrec.yaml] [--method grid|random|bayes] [--samples N]
        [--seed S] [--cpu]

The sweep file (default ``sweep/<model>.yaml``, read with PyYAML) maps
``section.key`` to a list of values; its optional ``method`` and
``samples`` keys are the defaults of the flags, and a ``metric`` key is
ignored. Every run is ``quickstart.run`` on the card unless ``--cpu`` asks
for the CPU; runs are selected by their best validation value. Prints
``{"best": ..., "all": [...]}`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(prog="python -m dr4sr_tpu_torch.tune")
    parser.add_argument("--model", "-m", type=str, default="SASRec")
    parser.add_argument("--dataset", "-d", type=str, default="amazon-toys")
    parser.add_argument("--root", type=str, default="dataset")
    parser.add_argument("--sweep", type=str, default=None,
                        help="sweep yaml path (default sweep/<model>.yaml)")
    parser.add_argument("--method", type=str, default=None,
                        choices=["grid", "random", "bayes"],
                        help="override the sweep file's `method` (default grid)")
    parser.add_argument("--samples", type=int, default=None,
                        help="number of draws for random/bayes search")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args(argv)

    import yaml

    from dr4sr_tpu_torch import quickstart
    from dr4sr_tpu_torch.config import load_config

    config = load_config(args.model, args.dataset)
    sweep_path = args.sweep or os.path.join("sweep", args.model.lower() + ".yaml")
    with open(sweep_path) as f:
        sweep = yaml.safe_load(f)
    # sweep files may carry wandb-style meta keys beside the grid; strip them
    # so that they never become dimensions
    file_method = sweep.pop("method", "grid")
    file_samples = sweep.pop("samples", None)
    sweep.pop("metric", None)
    best, results = quickstart.tune(config, sweep, root=args.root,
                                    method=args.method or file_method,
                                    samples=args.samples or file_samples, seed=args.seed,
                                    device="cpu" if args.cpu else "cuda")
    print(json.dumps({"best": best, "all": results}, indent=1, default=str))
    return best, results


if __name__ == "__main__":
    main()
