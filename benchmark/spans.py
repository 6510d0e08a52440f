"""What the span readers share: the port's spans (``dr4sr_tpu_torch/utils/
spans.py``, ``torch.profiler`` user ranges) as a ``harness.Trace`` holds
them among its host ops, set against the device's idle gaps.

The idle gaps are those of ``Trace.breakdown``: the stretches between
consecutive intervals of the device's activity (``trace.busy``). A reader
returns None where the trace's work lacks its cell's key; where the work is
there but a span is not (a program without spans), that span counts
nothing and its absence goes to standard error.
"""

from typing import List, Sequence, Tuple

import harness

Intervals = List[Tuple[float, float]]


def named(trace, names: Sequence[str]) -> List[Tuple[str, float, float]]:
    """The host ops named in ``names`` as (name, start, end) in µs, by start;
    a name the trace lacks is logged."""
    ops = [(name, start, end) for start, end, name in trace.host_ops if name in names]
    for name in sorted(set(names) - {name for name, _, _ in ops}):
        harness.log(f"span {name} not in this trace")
    return ops


def idle_gaps(trace) -> Intervals:
    return [(a, b) for (_, a), (b, _) in zip(trace.busy, trace.busy[1:])]


def overlap(xs: Intervals, ys: Intervals) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(trace, key: str, *names: str):
    """100 × the idle gaps' time inside the union of ``names``' spans / the
    traced wall time."""
    if not trace.work.get(key) or trace.window_s <= 0:
        return None
    inside = overlap(idle_gaps(trace), harness._union(named(trace, names)))
    return 100.0 * inside / 1e6 / trace.window_s


def host_ms(trace, key: str, *names: str):
    """The summed durations of ``names``' spans, in ms, per unit of the work
    under ``key``."""
    units = trace.work.get(key)
    if not units:
        return None
    return sum(end - start for _, start, end in named(trace, names)) / 1e3 / units
