"""The device's idle time while ``decode_dataset`` gathered a batch's
tokens, copied them back and cut them into the lanes' lists: the idle gaps
inside the span ``regen.collect``, as a share of the traced wall time.
Moves ``regen_seq_per_s``."""

import spans


def read(trace):
    return spans.idle_share(trace, "decode_positions", "regen.collect")
