"""The regeneration pipeline's command lines, one module per stage, with the
flags of the JAX package's ``scripts/`` of the same names (plus ``--cpu``
where a stage uses the card):

    python -m dr4sr_tpu_torch.scripts.build_pretraining_dataset --root_path D
    python -m dr4sr_tpu_torch.scripts.pretrain_regenerator --root_path D [--cpu]
    python -m dr4sr_tpu_torch.scripts.hybrid_inference --root_path D [--cpu]
    python -m dr4sr_tpu_torch.scripts.fused_pipeline --dataset NAME [--cpu]

They chain by files in the domain directory ``D``: ``patterns.npz`` and
``seq-pat-pair.pkl``, the regenerator checkpoint, ``train_regen.npz``.
Before them, ``python -m dr4sr_tpu_torch.scripts.preprocess`` builds ``D``
(train/val/test, ``meta.npz``, ``seq2pat_data.npz``) from raw files.
"""
