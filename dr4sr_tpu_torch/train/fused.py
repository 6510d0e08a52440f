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
  captured on a side stream into one shared memory pool, the trainer's
  generator registered with each.

On a mesh over NCCL a graph holds the step's collectives (the gradient
all-reduce over ``data``, EP's gathers over ``model``, CP's ring): they are
captured as the kernels are, and replayed in order on every rank, each
rank replaying its own graph of the same steps.

On the CPU a group's steps run eagerly one after another (the plain
version of the graph). On the card a group is captured or the call raises;
nothing falls back to eager steps.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dr4sr_tpu_torch.ops import attention
from dr4sr_tpu_torch.parallel.collectives import COUNTER

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


def _counts():
    """The attention kernels' launch counters and the collectives' counts."""
    return ((attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches),
            COUNTER.counts())


def _since(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    losses: torch.Tensor  # [n], rewritten by every replay
    launches: Tuple[int, int]  # attention launches in one replay
    collectives: Tuple[dict, dict]  # calls and bytes by (kind, axis) in one replay
    capture_ms: float


class StepGraphs:
    """CUDA graphs of groups of optimizer steps, for one trainer's state.

    ``run(kind, step, batches, extras)`` runs ``len(batches)`` calls of
    ``step`` (one optimizer step each, returning its loss), one a host
    batch:

    * the batches are stacked into pinned host buffers and from there, in
      one copy a key, into static ``[max_steps, B, ...]`` device inputs; a
      group of n reads their first n rows;
    * a kind's first group runs its steps eagerly on the capture stream:
      they load the kernels' libraries and make cuBLAS's workspace, cuFFT's
      plans and the optimizer's state, and they count as the steps they are;
    * a (kind, n) seen again is captured once (nothing runs during capture)
      and replayed. The graphs share one memory pool and are replayed one
      at a time on the current stream, so no graph's memory is in use while
      another runs;
    * the attention kernels' launch counters and the collectives' counter
      (``collectives.COUNTER``) are what ran: capture's increments are
      taken back out, and each replay adds them once.

    A graph reads the parameters, the optimizer's state, the meta
    parameters and ``extras`` by address: whoever rebinds one of them
    drops this object. Returns the [n] losses (a graph's own output tensor,
    rewritten by its next replay)."""

    def __init__(self, generator: torch.Generator, max_steps: int) -> None:
        self.device = generator.device
        self.generator = generator
        self.max_steps = int(max_steps)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Tuple[str, int], _Captured] = {}
        self.warm: set = set()
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
        n = self._stage(batches)
        captured = self.graphs.get((kind, n))
        if captured is None:
            batches = step_batches(self.inputs, extras, n)
            if kind not in self.warm:
                return self._warm_up(kind, step, batches)
            captured = self.graphs[(kind, n)] = self._capture(step, batches)
        return self._replay(captured)

    @staticmethod
    def _replay(captured: _Captured) -> torch.Tensor:
        captured.graph.replay()
        attention.flash_attention_fwd.launches += captured.launches[0]
        attention.flash_attention_bwd.launches += captured.launches[1]
        COUNTER.add_counts(captured.collectives)
        return captured.losses

    def _warm_up(self, kind: str, step: StepFn, batches: List[Batch]) -> torch.Tensor:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            losses = torch.stack([step(b) for b in batches])
        current.wait_stream(self.stream)
        self.warm.add(kind)
        return losses

    def _capture(self, step: StepFn, batches: List[Batch]) -> _Captured:
        graph = torch.cuda.CUDAGraph()
        # the trainer's generator draws inside the steps: registered, each
        # replay reads its offset and advances it by the whole graph's draws
        # (the default generator, dropout's, is registered by the capture)
        graph.register_generator_state(self.generator)
        before = _counts()
        t0 = time.perf_counter()
        # no garbage collection during capture: a collection that frees a
        # CUDA graph (or event) left in a reference cycle calls the CUDA
        # runtime, which invalidates the capture (seen on the card); torch
        # no longer collects before a capture itself
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        # errors on unsafe calls from this thread only: NCCL's watchdog
        # thread queries its collectives' events while this one captures
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                losses = torch.stack([step(b) for b in batches])
        finally:
            if collecting:
                gc.enable()
        ms = (time.perf_counter() - t0) * 1e3
        (fwd, bwd), (calls, nbytes) = _counts()
        # capture ran nothing: what the wrappers and collectives counted
        # runs at each replay
        (fwd0, bwd0), counts0 = before
        attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches = fwd0, bwd0
        COUNTER.restore(counts0)
        return _Captured(graph, losses, (fwd - fwd0, bwd - bwd0),
                         (_since(counts0[0], calls), _since(counts0[1], nbytes)), ms)
