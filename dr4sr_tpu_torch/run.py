"""CLI: train and evaluate one model on one dataset, with the port.

Usage (the root ``run.py``'s surface, minus the multi-device flags, which
come with the multi-GPU slice):

    python -m dr4sr_tpu_torch.run -m SASRec -d amazon-toys [--root dataset]
        [--train-file _ori] [--epochs N] [--cpu] [--set section.key=value ...]

``-m`` is SASRec, GRU4Rec, FMLP, CL4SRec, CL4SRec2, GNN, SGL, SimGCL, NCL,
ICLRec or MetaModel (DR4SR+, around ``model.sub_model``: e.g.
``-m MetaModel --set model.sub_model=SASRec``; ``--set`` and ``--epochs``
reach the sub-model's config too). It runs on the card unless ``--cpu``
asks for the CPU. Configs are read from ``configs/`` (PyYAML).
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(prog="python -m dr4sr_tpu_torch.run")
    parser.add_argument("--model", "-m", type=str, default="SASRec")
    parser.add_argument("--dataset", "-d", type=str, default="amazon-toys")
    parser.add_argument("--root", type=str, default="dataset", help="dataset root dir")
    parser.add_argument("--train-file", type=str, default=None,
                        help="override data.train_file (e.g. _ori, _regen)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="section.key=value",
                        help="config override, e.g. --set train.batch_size=512")
    args = parser.parse_args(argv)

    import yaml

    from dr4sr_tpu_torch.config import load_config
    from dr4sr_tpu_torch.data.dataset import prepare_datasets
    from dr4sr_tpu_torch.quickstart import make_trainer

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    config = load_config(args.model, args.dataset)
    if args.train_file is not None:
        config["data"]["train_file"] = args.train_file
    # the explicit overrides, kept so that MetaModel's trainer applies them
    # to the sub-model's freshly loaded config too
    cli: Dict[str, Dict] = {}
    if args.epochs is not None:
        cli.setdefault("train", {})["epochs"] = args.epochs
    for ov in args.overrides:
        key, _, value = ov.partition("=")
        section, _, name = key.partition(".")
        cli.setdefault(section, {})[name] = yaml.safe_load(value)
    for section, kv in cli.items():
        config.setdefault(section, {}).update(kv)
    config["_cli_overrides"] = cli

    datasets = prepare_datasets(config, root=args.root)
    trainer = make_trainer(config, datasets, device="cpu" if args.cpu else "cuda")
    trainer.fit()
    out = trainer.evaluate()
    # the validation selection score, so sweeps never select on test
    out["val_best"] = float(trainer.callback.best_value)
    print(out)
    return out


if __name__ == "__main__":
    main()
