"""The MLA attention forward's share of its roofline: the least time of the
attention work at Dqk 192 / Dv 128 in bf16 that the traced steps' masks
need, each layer's call once (``arith_moe.attention_fwd_bound_s``), over
the device time of the kernels that the port's attention op launches at
that shape (the probe ``attention_fwd``); remat's recomputed forward
counts in the time. Moves ``train_seq_per_s``."""

import readers


def read(trace):
    return readers.roofline(trace, "attn_fwd_bound_s", "attention_fwd", __name__)
