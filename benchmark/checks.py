"""The comparisons that decide ``correct``, shared by the entries.

Training (``training_numbers``): each step's loss against the reference's;
the first gradient as the optimizer got it (Adam's first moment after step
1, which is (1 − β1)·g on both sides), by the worst leaf; the parameters'
change after three steps, by the median leaf; and, where the cell reads
them, the change after the first epoch, by the worst leaf, and the mean
loss and the change of one epoch of the window, by the worst leaf, from
the state the program had before it. A leaf's gap is
that between the program's norm of it and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose first gradient in the reference is under a thousandth of the
median leaf's (nought to rounding, as a key's bias under softmax) are
left out of the gradient and the change.

Why the median leaf after three steps: Adam's first steps move every
coordinate by about the learning rate whatever its gradient's size, so a
coordinate whose gradient is near nought takes a sign from rounding, and
the worst leaf's gap swings from seed to seed (1e-7 to 7.5e-5 on 26
seeds of the regenerator, worst on the leaf that held such a coordinate),
which is no fault of either side. The median leaf is steady.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

SMALL_GRAD = 1e-3  # a leaf's first gradient under this share of the median leaf's is not counted


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def counted_leaves(ref_moment1: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(ref_moment1)
    floor = SMALL_GRAD * statistics.median(norms.values())
    return sorted(k for k, v in norms.items() if v >= floor)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Per leaf, |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    if set(prog) != set(ref):
        raise ValueError(f"the program's leaves {sorted(set(prog) ^ set(ref))} have no "
                         f"counterpart in the reference")
    p, r = _norms({k: prog[k] for k in leaves}), _norms({k: ref[k] for k in leaves})
    med = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in leaves}


def worst_leaf_gap(prog, ref, leaves: Sequence[str], what: str) -> float:
    """The largest of :func:`leaf_gaps`; the worst leaf is named on standard error."""
    gaps = leaf_gaps(prog, ref, leaves)
    worst = max(gaps, key=gaps.get)
    print(f"{what}: worst leaf {worst} {gaps[worst]!r}", file=sys.stderr)
    return gaps[worst]


def median_leaf_gap(prog, ref, leaves: Sequence[str], what: str) -> float:
    """The median of :func:`leaf_gaps`, with the worst leaf named on
    standard error beside it."""
    gaps = leaf_gaps(prog, ref, leaves)
    worst = max(gaps, key=gaps.get)
    print(f"{what}: median leaf {statistics.median(gaps.values())!r}; worst leaf {worst} "
          f"{gaps[worst]!r}", file=sys.stderr)
    return statistics.median(gaps.values())


def first_moments(optimizer, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Adam's first moment of each named parameter (zero where the optimizer
    holds none: a step that left its state untouched)."""
    return {k: optimizer.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone()
            for k, p in named.items()}


def change(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]):
    return {k: after[k].detach().double().cpu() - before[k].detach().double().cpu()
            for k in after}


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The widest relative gap of the losses, step by step."""
    if len(prog) != len(ref):
        return 1e9
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref))


def finite(x: float) -> float:
    """A compared number fit for JSON: NaN and infinities read 1e30."""
    return x if math.isfinite(x) else 1e30


def training_numbers(prog: dict, ref, leaves: Sequence[str]) -> Dict[str, float]:
    """``prog``: {losses, moment1, init, after3[, after_epoch][,
    before_window, window_loss, after_window]} of the program; ``ref``: the
    reference's run with the same fields. Both start from the same weights
    (both draw them from the seed), so the change of each is taken from its
    own start; the window's epoch starts both from ``before_window``."""
    out = {"loss_gap": loss_gap(prog["losses"], ref.losses),
           "grad_gap": worst_leaf_gap(prog["moment1"], ref.moment1, leaves, "grad_gap"),
           "update_gap": median_leaf_gap(change(prog["after3"], prog["init"]),
                                         change(ref.after3, ref.init), leaves, "update_gap")}
    if "after_epoch" in prog:
        out["epoch_update_gap"] = worst_leaf_gap(change(prog["after_epoch"], prog["init"]),
                                                 change(ref.after_epoch, ref.init), leaves,
                                                 "epoch_update_gap")
    if "after_window" in prog:
        start = prog["before_window"]
        out["window_loss_gap"] = loss_gap([prog["window_loss"]], [ref.window_loss])
        out["window_update_gap"] = worst_leaf_gap(change(prog["after_window"], start),
                                                  change(ref.after_window, start), leaves,
                                                  "window_update_gap")
    return {k: finite(v) for k, v in out.items()}


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from ``rng`` (Algorithm R)."""

    def __init__(self, size: int, rng: np.random.Generator) -> None:
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, make) -> None:
        """Offer the next item; ``make()`` builds it only if it is kept."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.items[j] = make()
