"""The MLA attention backward's share of its roofline: the least time of the
five products at Dqk 192 / Dv 128 in bf16 that the traced steps' masks
need (``arith_moe.attention_bwd_bound_s``), over the device time of the
kernels that the port's attention op launches in its backward at that
shape (the probe ``attention_bwd``). Moves ``train_seq_per_s``."""

import readers


def read(trace):
    return readers.roofline(trace, "attn_bwd_bound_s", "attention_bwd", __name__)
