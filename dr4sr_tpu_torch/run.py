"""CLI: train and evaluate one model on one dataset, with the port.

Usage (the root ``run.py``'s surface):

    python -m dr4sr_tpu_torch.run -m SASRec -d amazon-toys [--root dataset]
        [--train-file _ori] [--epochs N] [--cpu] [--set section.key=value ...]
        [--data-parallel D] [--model-parallel M] [--shard-embedding] [--multihost]

On several cards, one process a card under torchrun, each rank on
``cuda:{LOCAL_RANK}``:

    torchrun --nproc-per-node N -m dr4sr_tpu_torch.run -m SASRec -d amazon-toys \
        --data-parallel N

``--model-parallel M`` shapes a ``data`` × ``model`` mesh (``data``
defaults to world size / M); ``--shard-embedding`` row-shards the item
table over ``model``; ``--set model.context_parallel=M`` rings encoder
attention over it. Under torchrun the process group joins by itself (NCCL
on the card, gloo with ``--cpu``); ``--multihost`` asks for it without a
mesh flag, as the root CLI's does for ``jax.distributed``.

``-m`` is SASRec, GRU4Rec, FMLP, CL4SRec, CL4SRec2, GNN, SGL, SimGCL, NCL,
ICLRec or MetaModel (DR4SR+, around ``model.sub_model``: e.g.
``-m MetaModel --set model.sub_model=SASRec``; ``--set`` and ``--epochs``
reach the sub-model's config too). It runs on the card unless ``--cpu``
asks for the CPU. Configs are read from ``configs/`` (PyYAML).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(prog="python -m dr4sr_tpu_torch.run")
    parser.add_argument("--model", "-m", type=str, default="SASRec")
    parser.add_argument("--dataset", "-d", type=str, default="amazon-toys")
    parser.add_argument("--root", type=str, default="dataset", help="dataset root dir")
    parser.add_argument("--train-file", type=str, default=None,
                        help="override data.train_file (e.g. _ori, _regen)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    parser.add_argument("--data-parallel", type=int, default=None,
                        help="size of the data mesh axis (default: world size / model axis)")
    parser.add_argument("--shard-embedding", action="store_true",
                        help="row-shard the item table over the model axis")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="size of the model mesh axis")
    parser.add_argument("--multihost", action="store_true",
                        help="join torchrun's process group (env://) first")
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

    device = "cpu" if args.cpu else "cuda"
    mesh_plan = None
    wants_mesh = (args.data_parallel or 1) > 1 or args.model_parallel > 1
    if args.multihost or wants_mesh or "LOCAL_RANK" in os.environ:
        from dr4sr_tpu_torch.parallel.mesh import MeshPlan, create_mesh, init_distributed

        if not args.cpu:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(device)
        init_distributed(backend="gloo" if args.cpu else "nccl")
        mesh_plan = MeshPlan(mesh=create_mesh(data=args.data_parallel, model=args.model_parallel,
                                              device_type="cpu" if args.cpu else "cuda"),
                             shard_embedding=args.shard_embedding)

    datasets = prepare_datasets(config, root=args.root)
    trainer = make_trainer(config, datasets, device=device, mesh_plan=mesh_plan)
    trainer.fit()
    out = trainer.evaluate()
    if mesh_plan is not None:
        torch.distributed.destroy_process_group()
    # the validation selection score, so sweeps never select on test
    out["val_best"] = float(trainer.callback.best_value)
    print(out)
    return out


if __name__ == "__main__":
    main()
