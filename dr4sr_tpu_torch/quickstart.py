"""One-call train/evaluate entry and the sweep (port of
``dr4sr_tpu/quickstart.py``, reference ``quickstart/run.py``).

* :func:`make_trainer` — a ``MetaTrainer`` for DR4SR+, else a ``Trainer``;
* :func:`run` — seed, open ``log/<Model>/<dataset>/<stamp>.log`` under the
  working directory, build, ``fit``, ``evaluate``; the result holds the
  test metrics and ``val_best``, the best validation monitor value;
* :func:`tune` — grid, random or TPE (``bayes``) search over
  ``{'section.key': [values...]}``, selecting on ``val_best``. It draws
  from ``random.Random(seed)`` in the JAX package's order, so both packages
  propose the same combos.
"""

from __future__ import annotations

import copy
import datetime
import itertools
import random
from typing import Any, Dict, Optional, Tuple

from dr4sr_tpu_torch.data import dataset
from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.parallel.mesh import MeshPlan
from dr4sr_tpu_torch.train.trainer import Trainer
from dr4sr_tpu_torch.utils.env import setup_environment
from dr4sr_tpu_torch.utils.logger import get_logger


Datasets = Tuple[dataset.SeqDataset, dataset.SeqDataset, dataset.SeqDataset]


def make_trainer(config: Dict[str, Any], datasets: Datasets,
                 workdir: Optional[str] = None, device="cuda",
                 mesh_plan: Optional[MeshPlan] = None) -> Trainer:
    """A ``MetaTrainer`` for a bilevel model (``is_meta``: MetaModel), else a
    ``Trainer``; on ``device`` (the card unless the caller asks otherwise),
    over ``mesh_plan``'s ranks when one is given."""
    if getattr(get_model_class(config["model"]["model"]), "is_meta", False):
        from dr4sr_tpu_torch.train.meta_trainer import MetaTrainer

        return MetaTrainer(config, datasets, workdir=workdir, device=device,
                           mesh_plan=mesh_plan)
    return Trainer(config, datasets, workdir=workdir, device=device, mesh_plan=mesh_plan)


def run(
    config: Dict[str, Any],
    root: Optional[str] = None,
    mesh_plan: Optional[MeshPlan] = None,
    device="cuda",
) -> Dict[str, float]:
    with setup_environment(config["train"]):
        stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S-%f")
        log_path = f"{config['model']['model']}/{config['data']['dataset']}/{stamp}.log"
        logger = get_logger(log_path)
        logger.info(f"config: {config}")

        datasets = dataset.prepare_datasets(config, root=root)
        logger.info(
            f"dataset {config['data']['dataset']}: {len(datasets[0])} train rows, "
            f"{datasets[0].num_users} users, {datasets[0].num_items} items"
        )
        trainer = make_trainer(config, datasets, device=device, mesh_plan=mesh_plan)
        trainer.fit()
        out = trainer.evaluate()
    # expose the validation selection score so sweeps never select on test
    out["val_best"] = float(trainer.callback.best_value)
    return out


def tune(
    config: Dict[str, Any],
    sweep: Dict[str, list],
    root: Optional[str] = None,
    method: str = "grid",
    samples: Optional[int] = None,
    seed: int = 0,
    device="cuda",
):
    """Hyperparameter sweep over ``{'section.key': [values...]}`` (replaces
    the wandb sweep of ``tune.py``, which supports grid/random/bayes via
    ``transform_config_into_sweep_config``). ``method='grid'`` enumerates the
    product; ``method='random'`` draws ``samples`` combos uniformly (with
    replacement, like wandb random search); ``method='bayes'`` runs a
    dependency-free TPE-style sequential search over the discrete candidate
    lists (good/bad density ratio with Laplace smoothing). Selection uses the
    best VALIDATION monitor value (never test metrics). Every run is
    :func:`run` on ``device``. Returns (the best run, every run), each
    ``{"params": ..., "metrics": ...}``."""
    keys = sorted(sweep)
    if method == "random":
        rng = random.Random(seed)
        n = samples or 10
        combos = [tuple(rng.choice(sweep[k]) for k in keys) for _ in range(n)]
    elif method == "grid":
        combos = list(itertools.product(*(sweep[k] for k in keys)))
    elif method == "bayes":
        combos = None  # proposed sequentially below
    else:
        raise ValueError(f"unknown sweep method {method!r}")

    best = None
    results = []
    observed = []  # (combo, score) for bayes proposals

    def evaluate(combo):
        nonlocal best
        cfg = copy.deepcopy(config)
        for k, v in zip(keys, combo):
            section, _, key = k.partition(".")
            cfg[section][key] = v
        out = run(cfg, root=root, device=device)
        score = out["val_best"]
        results.append({"params": dict(zip(keys, combo)), "metrics": out})
        observed.append((combo, score))
        if best is None or score > best[0]:
            best = (score, results[-1])

    if method == "bayes":
        rng = random.Random(seed)
        n = samples or 10
        n_init = max(2, min(n // 3, 5))
        # warmup draws without replacement — a duplicate combo would burn a
        # full training run re-measuring a point TPE already has
        drawn = set()
        attempts = 0
        while len(drawn) < min(n_init, n) and attempts < 100 * n_init:
            attempts += 1
            combo = tuple(rng.choice(sweep[k]) for k in keys)
            if combo in drawn:
                continue
            drawn.add(combo)
            evaluate(combo)
        while len(observed) < n:
            evaluate(_tpe_propose(keys, sweep, observed, rng))
    else:
        for combo in combos:
            evaluate(combo)
    return best[1], results


def _tpe_propose(keys, sweep, observed, rng, n_candidates=256, gamma=0.25):
    """Propose the next combo: split observations into good (top ``gamma``
    fraction by score) and bad, then pick the candidate maximizing the
    per-dimension likelihood ratio P(value | good) / P(value | bad) with
    add-one smoothing — the discrete-space TPE acquisition. Already-evaluated
    combos are excluded while unseen ones remain."""
    ranked = sorted(observed, key=lambda t: -t[1])
    n_good = max(1, int(len(ranked) * gamma))
    good = [c for c, _ in ranked[:n_good]]
    bad = [c for c, _ in ranked[n_good:]] or good
    seen = {c for c, _ in observed}

    def ratio(combo):
        r = 1.0
        for i, k in enumerate(keys):
            vals = sweep[k]
            pg = (sum(g[i] == combo[i] for g in good) + 1) / (len(good) + len(vals))
            pb = (sum(b[i] == combo[i] for b in bad) + 1) / (len(bad) + len(vals))
            r *= pg / pb
        return r

    cands = {tuple(rng.choice(sweep[k]) for k in keys)
             for _ in range(n_candidates)}
    unseen = [c for c in cands if c not in seen]
    pool = unseen or list(cands)
    return max(pool, key=ratio)
