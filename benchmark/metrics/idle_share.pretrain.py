"""The device's idle share of the traced wall time: 1 − (the union of the
device's activity intervals) / (the traced slice's wall time). Moves
``pretrain_seq_per_s``."""

import readers


def read(trace):
    return readers.idle_share(trace, "train_steps")
