"""dr4sr_tpu_torch — the PyTorch/CUDA port of ``dr4sr_tpu`` for an NVIDIA H100.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and ``numpy`` and nothing of JAX or of ``dr4sr_tpu``. Entry points
run on ``device="cuda"`` unless the caller asks for the CPU; on the card every
Pallas kernel of the path is a hand-written CUDA kernel (``ops/csrc/``), built
with ``nvcc`` at first use.

Ported so far: SASRec serving (``serve.Recommender``) with the flash-attention
forward kernel.

Importing the package loads no kernel and builds nothing.
"""

__version__ = "0.1.0"
