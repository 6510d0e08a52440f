"""The device's idle time while the host fetched and staged training
batches: the idle gaps inside the spans ``train.load`` and ``train.stage``
(``Trainer.training_epoch``, ``fused_steps``, ``StepGraphs._stage``), as a
share of the traced wall time. Moves ``train_seq_per_s``."""

import spans


def read(trace):
    return spans.idle_share(trace, "train_steps", "train.load", "train.stage")
