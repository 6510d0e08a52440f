"""The attention forward's share of its roofline: the least time of the
attention work that the traced steps' shapes and masks need
(``arith.attention_fwd_bound_s``, a fixed amount whatever implements it)
over the device time of the kernels that the port's attention op
launches in its forward (``probes.py``). Moves ``pretrain_seq_per_s``."""

import readers


def read(trace):
    return readers.roofline(trace, "attn_fwd_bound_s", "attention_fwd", __name__)
