"""Named spans around the host work of the port's loops.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler session is open (the benchmark's traced runs,
``train.profile_epoch``, or a caller's own ``torch.profiler.profile``), so
the span lies on the same timeline as the card's kernels and copies; with
no session it is one shared null context, at the cost of one check. Spans
of one name are siblings, never nested in each other, so a span's duration
is its own stretch of host work. :data:`SPANS` holds every name.
"""

from __future__ import annotations

import contextlib

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
    "regen.collect": "a decode batch's tokens gathered, copied back and cut into lists",
}

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a session is open, else a null
    context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
