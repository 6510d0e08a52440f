"""CUDA graphs of the port's loops: one protocol for training, decoding and
serving.

A group of optimizer steps (``train/fused.py::StepGraphs``), a batch of the
KV-cached greedy decode (``regen/decode.py``) and a chunk of serving's score
and top-k (``serve.py::Recommender``) each replay a CUDA graph where their
Python loop would launch its kernels one by one. Each caller stages its own
static inputs and passes ``fn``, a closure over them with no arguments;
:class:`CudaGraphs` holds the rest, by key:

* a key's first call runs ``fn`` eagerly on a side stream: it loads the
  kernels' libraries and makes cuBLAS's workspace (and cuFFT's plans, an
  optimizer's state) on the stream the capture will use, and its outputs
  are the call's;
* the key's next call captures ``fn`` once on that stream (nothing runs
  during capture) into the one memory pool every key shares, then replays
  it, as every later call does, on the current stream. The graphs are
  replayed one at a time, so no graph's memory is in use while another
  runs;
* the attention kernels' launch counters and the collectives' counter
  (``parallel/collectives.py::COUNTER``) read what ran: what a capture
  counted is taken back out, and each replay adds it once;
* a graph reads its inputs and the weights by address: a value changed in
  place is seen, and whoever rebinds one drops the graphs
  (:meth:`CudaGraphs.watch` does so for a module's weights).

On the CPU the callers run ``fn`` eagerly and build no ``CudaGraphs``.
"""

from __future__ import annotations

import gc
import weakref
from typing import Any, Callable, Dict, Hashable, NamedTuple, Optional, Sequence, Tuple

import torch

from dr4sr_tpu_torch.ops import attention
from dr4sr_tpu_torch.parallel.collectives import COUNTER


def _counts():
    """The attention kernels' launch counters and the collectives' counts."""
    return ((attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches),
            COUNTER.counts())


def _since(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def _slots(module: torch.nn.Module) -> tuple:
    """Where each parameter, buffer and submodule of ``module`` is held."""
    mods = list(module.modules())
    return ([(d, name) for m in mods for d in (m._parameters, m._buffers)
             for name, t in d.items() if t is not None],
            [(m._modules, name) for m in mods for name in m._modules])


def _bindings(slots: tuple) -> tuple:
    """What the slots hold now: each tensor's address, each submodule."""
    tensors, modules = slots
    return (tuple(d[name].data_ptr() for d, name in tensors),
            tuple(d[name] for d, name in modules))


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    outputs: Any  # fn()'s outputs, rewritten by every replay
    launches: Tuple[int, int]  # attention (forward, backward) launches in one replay
    collectives: Tuple[dict, dict]  # calls and bytes by (kind, axis) in one replay


class CudaGraphs:
    """The CUDA graphs of one caller on ``device``, by key: a side stream,
    one memory pool, the captured graphs and the warmed keys.
    ``generators`` are the ``torch.Generator``s ``fn`` draws from besides
    the default one, registered with every graph."""

    def __init__(self, device, generators: Sequence[torch.Generator] = ()) -> None:
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Hashable, _Captured] = {}
        self.warm: set = set()
        self._watched: Optional[tuple] = None  # (the module, weakly; its slots; their bindings)

    def run(self, key: Hashable, fn: Callable[[], Any],
            warm_key: Optional[Hashable] = None) -> Any:
        """``fn()``'s outputs: eagerly while ``warm_key`` (``key`` when None)
        has not run, else from ``key``'s graph, captured at its first such
        call. A caller whose keys share their warm-up (a trainer's kind at
        every group length) passes the shared part as ``warm_key``."""
        if key not in self.graphs:
            warm_key = key if warm_key is None else warm_key
            if warm_key not in self.warm:
                return self._warm_up(warm_key, fn)
            self.capture(key, fn)
        return self.replay(key)

    def _warm_up(self, warm_key: Hashable, fn: Callable[[], Any]) -> Any:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            outputs = fn()
        current.wait_stream(self.stream)
        self.warm.add(warm_key)
        return outputs

    def capture(self, key: Hashable, fn: Callable[[], Any]) -> None:
        """``fn`` captured as ``key``'s graph; nothing runs. For a caller
        that stages its inputs between the capture and the replay;
        :meth:`run` captures by itself."""
        graph = torch.cuda.CUDAGraph()
        # a generator drawn from inside fn: registered, each replay reads its
        # offset and advances it by the whole graph's draws (the default
        # generator, dropout's, is registered by the capture)
        for generator in self.generators:
            graph.register_generator_state(generator)
        before = _counts()
        # no garbage collection during capture: a collection that frees a
        # CUDA graph (or event) left in a reference cycle calls the CUDA
        # runtime, which invalidates the capture (seen on the card); torch
        # no longer collects before a capture itself
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        # errors on unsafe calls from this thread only: under a mesh over
        # NCCL its watchdog thread queries its collectives' events while this
        # one captures
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = fn()
        finally:
            if collecting:
                gc.enable()
        (fwd, bwd), (calls, nbytes) = _counts()
        # capture ran nothing: what the wrappers and collectives counted
        # runs at each replay
        (fwd0, bwd0), counts0 = before
        attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches = fwd0, bwd0
        COUNTER.restore(counts0)
        self.graphs[key] = _Captured(graph, outputs, (fwd - fwd0, bwd - bwd0),
                                     (_since(counts0[0], calls), _since(counts0[1], nbytes)))

    def replay(self, key: Hashable) -> Any:
        """One replay of ``key``'s graph on the current stream; its outputs."""
        captured = self.graphs[key]
        captured.graph.replay()
        attention.flash_attention_fwd.launches += captured.launches[0]
        attention.flash_attention_bwd.launches += captured.launches[1]
        COUNTER.add_counts(captured.collectives)
        return captured.outputs

    def watch(self, module: torch.nn.Module) -> None:
        """Drops every graph if a parameter, buffer or submodule of
        ``module`` was rebound to other storage since the last call, or
        ``module`` is another than the last call's (a few µs a call). The
        module is held weakly: its graphs do not keep it alive."""
        watched = self._watched
        if (watched is not None and watched[0]() is module
                and _bindings(watched[1]) == watched[2]):
            return
        self.graphs.clear()
        slots = _slots(module)
        self._watched = (weakref.ref(module), slots, _bindings(slots))
