"""Device time per request: the union of the device's activity intervals
over the traced requests, in ms. Moves ``serve_ms_p95``."""

import readers


def read(trace):
    return readers.per_unit(1e3 * trace.busy_s, trace, "requests")
