"""Kernel and graph launches the host made per decode position of one
batch (``max_len`` − 1 positions a batch): the profiler's launch calls
over the traced positions. Moves ``regen_seq_per_s``."""

import readers


def read(trace):
    return readers.per_unit(trace.launches, trace, "decode_positions")
