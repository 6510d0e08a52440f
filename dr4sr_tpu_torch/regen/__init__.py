"""The dataset regenerator (the "DR" in DR4SR): pattern mining, the
seq2seq regenerator, its batched decode, and the pipeline that assembles
``train_regen``. Port of ``dr4sr_tpu/regen/``."""
