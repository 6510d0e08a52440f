"""The device's idle time inside the MoE layers' spans ``moe.route``,
``moe.experts`` and ``moe.combine`` (``modules/moe.py``), as a share of the
traced wall time, in %: a host synchronisation inside the layer (a count
read back to size a product) shows here as the device waiting. The longest
idle stretch inside the spans goes to standard error. Moves
``train_seq_per_s``."""

import harness
import spans

NAMES = ("moe.route", "moe.experts", "moe.combine")


def _longest(xs, ys):
    """The longest piece of the intersection of two sorted lists of disjoint
    intervals."""
    best, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        best = max(best, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return best


def read(trace):
    share = spans.idle_share(trace, "train_steps", *NAMES)
    if share:
        longest = _longest(spans.idle_gaps(trace), harness._union(spans.named(trace, NAMES)))
        harness.log(f"moe_idle_share.moe: longest idle stretch inside a moe.* span {longest!r} us")
    return share
