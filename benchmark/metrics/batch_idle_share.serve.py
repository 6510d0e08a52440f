"""The device's idle time while ``Recommender.recommend`` padded a chunk's
histories and copied them to the device: the idle gaps inside the span
``serve.batch``, as a share of the traced wall time. Moves
``serve_ms_p95``."""

import spans


def read(trace):
    return spans.idle_share(trace, "requests", "serve.batch")
