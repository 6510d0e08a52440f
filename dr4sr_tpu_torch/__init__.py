"""dr4sr_tpu_torch — the PyTorch/CUDA port of ``dr4sr_tpu`` for an NVIDIA H100.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and ``numpy`` and nothing of JAX or of ``dr4sr_tpu``. Entry points
run on ``device="cuda"`` unless the caller asks for the CPU; on the card every
Pallas kernel of the path is a hand-written CUDA kernel (``ops/csrc/``), built
with ``nvcc`` at first use.

Ported so far: serving (``serve.Recommender``) and training
(``train.trainer.Trainer.fit``, ``python -m dr4sr_tpu_torch.run``) of SASRec
and the sequential zoo (GRU4Rec, FMLP, CL4SRec, CL4SRec2), with the
flash-attention forward and backward kernels; every dataset class
(``general`` and the ablation classes); the regeneration pipeline
(``regen/``: mining, pretraining the regenerator, hybrid decode,
``train_regen``; CLIs under ``scripts/``).

Importing the package loads no kernel and builds nothing.
"""

__version__ = "0.1.0"
