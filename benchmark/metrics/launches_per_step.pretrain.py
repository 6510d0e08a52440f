"""Kernel and graph launches the host made per optimizer step: the
profiler's ``cudaLaunchKernel``/``cuLaunchKernel``/``cudaGraphLaunch``
calls over the traced steps. Moves ``pretrain_seq_per_s``."""

import readers


def read(trace):
    return readers.per_unit(trace.launches, trace, "train_steps")
