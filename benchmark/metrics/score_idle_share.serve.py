"""The device's idle time while the host dispatched a chunk's encoder
forward and masked top-k: the idle gaps inside the span ``serve.score``, as
a share of the traced wall time. Moves ``serve_ms_p95``."""

import spans


def read(trace):
    return spans.idle_share(trace, "requests", "serve.score")
