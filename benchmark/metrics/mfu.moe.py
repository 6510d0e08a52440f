"""The MoE training step's share of the card's dense bf16 peak (989
TFLOP/s): the FLOPs that the traced steps' real positions need
(``arith_moe.step_flops``: MLA, the dense layer, the router, the shared
experts, the held experts' assignments by the program's load counter,
attention at Dqk 192 / Dv 128, the scores; the backward as twice the
forward, remat's recomputation not counted), over the traced wall time.
Moves ``train_seq_per_s``."""

import readers


def read(trace):
    return readers.mfu(trace)
