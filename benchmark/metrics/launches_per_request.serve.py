"""Kernel and graph launches the host made per request: the profiler's
``cudaLaunchKernel``/``cuLaunchKernel``/``cudaGraphLaunch`` calls over the
traced requests. An eager chunk launches each kernel of the encoder's
forward, the catalog product, the masks and the top-k; a replayed one
launches its CUDA graph once. Moves ``serve_ms_p95``."""

import readers


def read(trace):
    return readers.per_unit(trace.launches, trace, "requests")
