"""The device's idle share of the traced wall time: 1 − (the union of the
device's activity intervals) / (the traced slice's wall time). Moves
``regen_seq_per_s``."""

import readers


def read(trace):
    return readers.idle_share(trace, "decode_positions")
