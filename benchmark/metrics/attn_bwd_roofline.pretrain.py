"""The attention backward's share of its roofline: the least time of the
backward work that the traced steps' shapes and masks need
(``arith.attention_bwd_bound_s``) over the device time of the kernels
that the port's attention op launches in its backward (``probes.py``).
Moves ``pretrain_seq_per_s``."""

import readers


def read(trace):
    return readers.roofline(trace, "attn_bwd_bound_s", "attention_bwd", __name__)
