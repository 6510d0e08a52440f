"""Environment setup (port of ``dr4sr_tpu/utils/env.py``).

The reference seeds torch/np/random and pins CUDA devices
(``utils/utils.py:13-30``). The port's trainers seed their own torch
generators from ``train.seed``, so "seeding" here covers the host-side
Python and numpy streams, as in the JAX package. The JAX-only keys of the
train config map as follows:

* ``debug_nans`` → ``torch.autograd.set_detect_anomaly(True,
  check_nan=True)`` for the run, undone after it (JAX's ``jax_debug_nans``:
  the backward raises where a NaN appears);
* ``disable_jit`` → the fused groups (``train.steps_per_dispatch > 1``) run
  eagerly: the same steps without a CUDA graph, as on the CPU. The
  ``Trainer`` reads the key itself;
* ``no_compile_cache`` → accepted and ignored: there is no XLA compilation
  cache to keep (the CUDA kernels are cached by ``ops/_build.py``);
* ``rng_impl`` → refused, here and by the ``Trainer``: it chooses JAX's
  PRNG implementation, and the port draws from torch generators.
"""

from __future__ import annotations

import contextlib
import os
import random
from typing import Any, Dict, Iterator

import numpy as np
import torch


def seed_everything(seed: int = 1111) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def refuse_rng_impl(train_config: Dict[str, Any]) -> None:
    """``train.rng_impl`` chooses JAX's PRNG implementation: refused (by
    :func:`setup_environment` and by the ``Trainer``)."""
    if train_config.get("rng_impl"):
        raise NotImplementedError(
            f"train.rng_impl={train_config['rng_impl']!r} chooses JAX's PRNG implementation; "
            f"the port draws from torch generators and has no such choice")


@contextlib.contextmanager
def setup_environment(train_config: Dict[str, Any]) -> Iterator[None]:
    """Seed from ``train.seed`` and hold the debug mode of ``train_config``
    for the body of the ``with``."""
    refuse_rng_impl(train_config)
    seed_everything(int(train_config.get("seed", 2023)))
    if train_config.get("debug_nans"):
        with torch.autograd.set_detect_anomaly(True, check_nan=True):
            yield
    else:
        yield
