"""The device's idle share of the traced wall time: 1 − (the union of the
device's activity intervals) / (the traced slice's wall time). Moves
``serve_ms_p95``."""

import readers


def read(trace):
    return readers.idle_share(trace, "requests")
