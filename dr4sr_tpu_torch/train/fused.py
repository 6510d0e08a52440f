"""Fused multi-step dispatch (``train.steps_per_dispatch = N > 1``).

Port of the JAX trainer's ``multi_train_step`` and ``_device_batch_stack``
(``dr4sr_tpu/train/trainer.py``) and the bilevel trainer's
``multi_weighted_train_step`` (``dr4sr_tpu/train/meta_trainer.py``): JAX
runs a group of N optimizer steps as one jitted ``lax.scan``; here a group
is one replay of a CUDA graph that holds the N whole steps (forward through
the attention kernels, backward, optimizer), so the host launches one graph
where it launched some 200 kernels a step. The semantics are the per-step
path's: the same batches in the same order, and the same random draws
(negatives and the models' other draws from the trainer's generator,
dropout from the default CUDA generator), so the draws of one replay equal
those of N eager steps.

* :func:`stack_batches` — N host batches as ``[N, B, ...]`` CPU tensors,
  int32 widened to int64 as ``Trainer.device_batch`` widens them;
* :func:`step_batches` — the N per-step batches of a stack, each with the
  trainer's ``batch_extras``;
* :func:`capture_refusal` — why a trainer's steps cannot be captured: on
  the card over a gloo mesh axis, and only there;
* :class:`StepGraphs` — the graphs of one trainer: static ``[N, B, ...]``
  inputs fed from pinned host buffers, one graph per (kind, group length)
  through ``ops/graphs.py``, the trainer's generator registered with each.

On a mesh over NCCL a graph holds the step's collectives (the gradient
all-reduce over ``data``, EP's gathers over ``model``, CP's ring): they are
captured as the kernels are, and replayed in order on every rank, each
rank replaying its own graph of the same steps.

On the CPU a group's steps run eagerly one after another (the plain
version of the graph). On the card a group is captured or the call raises;
nothing falls back to eager steps.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from dr4sr_tpu_torch.ops.graphs import CudaGraphs
from dr4sr_tpu_torch.utils.spans import span

Batch = Dict[str, torch.Tensor]
HostBatch = Dict[str, np.ndarray]
StepFn = Callable[[Batch], torch.Tensor]


def _widened(dtype: np.dtype) -> np.dtype:
    """A host array's dtype on the device: int32 widened to int64."""
    return np.dtype(np.int64) if dtype == np.int32 else dtype


def stack_batches(batches: List[HostBatch]) -> Dict[str, torch.Tensor]:
    """``[N, B, ...]`` CPU tensors of N same-shape host batches."""
    return {key: torch.from_numpy(np.stack([b[key] for b in batches]).astype(
        _widened(batches[0][key].dtype), copy=False)) for key in batches[0]}


def step_batches(stacked: Batch, extras: Batch, n: int) -> List[Batch]:
    """Step ``i``'s batch: row ``i`` of every stacked key, and ``extras``."""
    return [{**{k: v[i] for k, v in stacked.items()}, **extras} for i in range(n)]


def capture_refusal(device, backends: Iterable[str]) -> Optional[str]:
    """Why the steps of a trainer on ``device``, whose mesh axes of more
    than one rank run over ``backends``, cannot be captured into CUDA
    graphs, or None. One case: a CUDA device and a gloo axis, whose
    collectives stage CUDA tensors through host memory
    (``parallel/collectives.py::stages_through_host``)."""
    if torch.device(device).type == "cuda" and "gloo" in set(backends):
        return ("its mesh runs over gloo, which stages CUDA tensors through host memory "
                "(dr4sr_tpu_torch/parallel/collectives.py::stages_through_host) where a CUDA "
                "graph cannot follow; run the mesh over NCCL (a card a rank)")
    return None


class StepGraphs:
    """CUDA graphs of groups of optimizer steps, for one trainer's state.

    ``run(kind, step, batches, extras)`` runs ``len(batches)`` calls of
    ``step`` (one optimizer step each, returning its loss), one a host
    batch, and returns the [n] losses. What it stages: the batches, stacked
    into pinned host buffers and from there, in one copy a key, into static
    ``[max_steps, B, ...]`` device inputs, of which a group of n reads the
    first n rows. Its graphs (``ops/graphs.py``) are keyed by (kind, n),
    with the trainer's generator registered: a kind's first group runs
    eagerly whatever its length, and each (kind, n) after it is captured at
    its first group and replayed.

    A graph reads the parameters, the optimizer's state, the meta
    parameters and ``extras`` by address: whoever rebinds one of them
    drops this object. The losses are a graph's own output tensor,
    rewritten by its next replay."""

    def __init__(self, generator: torch.Generator, max_steps: int) -> None:
        self.device = generator.device
        self.max_steps = int(max_steps)
        self.cuda = CudaGraphs(self.device, generators=(generator,))
        self.inputs: Optional[Batch] = None
        self.pinned: Batch = {}
        self._layout: Optional[dict] = None  # {key: (dtype, one batch's shape)}
        self._copied: Optional[torch.cuda.Event] = None

    # ---------------------------------------------------------------- inputs
    def _copy_in(self, batches: List[HostBatch]) -> None:
        """Host batches → the pinned buffers (int32 widened on the way) →
        the static inputs, one copy a key on the current stream. The pinned
        buffers are rewritten only after the previous group's copy out of
        them has finished."""
        n = len(batches)
        if self._copied is not None:
            self._copied.synchronize()
        for key, pinned in self.pinned.items():
            host = pinned.numpy()
            for i, batch in enumerate(batches):
                np.copyto(host[i], batch[key])
            self.inputs[key][:n].copy_(pinned[:n], non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()

    def _stage(self, batches: List[HostBatch]) -> int:
        n = len(batches)
        if not 1 <= n <= self.max_steps:
            raise ValueError(f"a group of {n} steps; this trainer dispatches 1 to "
                             f"{self.max_steps}")
        layout = {k: (_widened(v.dtype), v.shape) for k, v in batches[0].items()}
        if self._layout is None:
            self._layout, self.inputs = layout, {}
            for key, (dtype, shape) in layout.items():
                pinned = torch.from_numpy(np.empty((self.max_steps,) + shape, dtype))
                self.pinned[key] = pinned.pin_memory()
                self.inputs[key] = torch.empty_like(pinned, device=self.device)
        if layout != self._layout:
            raise ValueError(f"a group's batches {layout} differ from the graphs' inputs "
                             f"{self._layout}")
        self._copy_in(batches)
        return n

    # ------------------------------------------------------------------ steps
    def run(self, kind: str, step: StepFn, batches: List[HostBatch],
            extras: Batch) -> torch.Tensor:
        with span("train.stage"):
            n = self._stage(batches)
        return self.cuda.run(
            (kind, n),
            lambda: torch.stack([step(b) for b in step_batches(self.inputs, extras, n)]),
            warm_key=kind)
