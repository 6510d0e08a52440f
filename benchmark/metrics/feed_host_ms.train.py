"""The host's time fetching and staging training batches: the summed
durations of the spans ``train.load`` and ``train.stage``, in ms per
optimizer step. Moves ``train_seq_per_s``."""

import spans


def read(trace):
    return spans.host_ms(trace, "train_steps", "train.load", "train.stage")
