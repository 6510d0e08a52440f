"""The host's time per decode position: the summed durations of the span
``regen.position`` (the step, the pick, the buffer updates), in ms per
position. Moves ``regen_seq_per_s``."""

import spans


def read(trace):
    return spans.host_ms(trace, "decode_positions", "regen.position")
