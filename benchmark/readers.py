"""What the per-layer metric readers (``metrics/<metric>.py``) share: each
takes a ``harness.Trace`` and the key of the entry's work that it counts
by, and returns None where the trace holds nothing for it to read."""

import arith
import harness


def per_unit(count: float, trace, key: str):
    units = trace.work.get(key)
    return count / units if units else None


def idle_share(trace, key: str):
    """100 × (1 − the union of the device's activity / the traced wall time)."""
    if not trace.work.get(key) or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(trace):
    """100 × the step's FLOPs (``arith``) / (traced wall time × 989 TFLOP/s)."""
    flops = trace.work.get("flops")
    return 100.0 * flops / (trace.window_s * arith.PEAK_FLOPS_BF16) if flops else None


def roofline(trace, bound_key: str, probe: str, metric: str):
    """100 × the work's least time (``arith``) / the device time of the
    slice's kernels that the port's attention op launched in ``probe``
    (``probes.py``), whatever their names. The kernels counted go to
    standard error."""
    bound, device = trace.work.get(bound_key), trace.probed_device_s(probe)
    if not bound or device <= 0:
        return None
    counts = {}
    for name, _, _ in trace.probed_kernels(probe):
        counts[name] = counts.get(name, 0) + 1
    harness.log(f"{metric}: {device!r} s on the device in {counts}")
    return 100.0 * bound / device
