"""Named spans around the host work of the port's loops.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler session is open (the benchmark's traced runs,
``train.profile_epoch``, or a caller's own ``torch.profiler.profile``), so
the span lies on the same timeline as the card's kernels and copies; with
no session it is one shared null context, at the cost of one check. Spans
of one name are siblings, never nested in each other, so a span's duration
is its own stretch of host work. :data:`SPANS` holds every name.

``count(name, value)`` adds a device tensor to a counter on the device
while a profiler session is open (no host synchronisation; a layer that
remat recomputes inside the backward is not counted twice), and
``read_counts()`` copies the counters to the host once, for a traced run to
read; ``reset_counts()`` clears them. :data:`COUNTERS` holds every name.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

SPANS = {
    "train.load": "the loader's next group of batches: its permutation and row gathers",
    "train.stage": "a group's batches made ready for the device: host_shard, the pinned "
                   "buffers and the copies to the card, or device_batch / stack_batches",
    "serve.batch": "a chunk of histories padded and copied to the device",
    "serve.score": "the chunk's encoder forward and masked top-k, enqueued",
    "serve.fetch": "the chunk's items and scores copied back to numpy",
    "regen.encode": "a decode batch's encoder, source mask, caches and buffers",
    "regen.position": "one decode position: the step, the pick, the buffer updates",
    "regen.replay": "a graphed decode batch: the copies into the graph's inputs and its launch",
    "regen.collect": "a decode batch's tokens gathered, copied back and cut into lists",
    "moe.route": "a MoE layer's router, top-k, group ends and the gather of the held "
                 "experts' tokens",
    "moe.experts": "the held experts' grouped products (gate, up, down)",
    "moe.combine": "the held experts' rows put back to their tokens and summed, and the "
                   "shared experts",
}

COUNTERS = {
    "moe.assignments": "the top-k assignments that landed on each expert a MoE layer holds, "
                       "summed over the layers and the forward passes: [experts held]",
    "moe.tokens": "the tokens (pads left out) routed through the MoE layers, summed alike",
}
_COUNTS: Dict[str, torch.Tensor] = {}

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a session is open, else a null
    context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, value: torch.Tensor) -> None:
    """Add ``value`` to the counter ``name`` on its device while a profiler
    session is open, outside the autograd engine's backward (where remat
    recomputes a layer); else nothing."""
    if not torch.autograd._profiler_enabled() or torch._C._current_graph_task_id() != -1:
        return
    value = value.detach().to(torch.int64)
    if name in _COUNTS:
        _COUNTS[name].add_(value)
    else:
        _COUNTS[name] = value.clone()


def read_counts() -> Dict[str, np.ndarray]:
    """The counters on the host (one copy each, which waits for the device)."""
    return {name: t.cpu().numpy() for name, t in _COUNTS.items()}


def reset_counts() -> None:
    _COUNTS.clear()
