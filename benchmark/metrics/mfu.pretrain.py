"""The whole training step's share of the card's dense bf16 peak (989
TFLOP/s): the matrix-product and attention FLOPs that the traced steps'
real positions need (``arith.*_step_flops``, the backward as twice the
forward), over the traced wall time. Moves ``pretrain_seq_per_s``."""

import readers


def read(trace):
    return readers.mfu(trace)
