"""What the port's attention op launches, learnt by profiling it alone.

Under a CUDA graph replay, the training cell's whole window, the
profiler's tree ends at the graph launch: no kernel there sits under the
op that captured it. So a traced run first calls the op alone, at each of
the cell's attention shapes, under the profiler: every kernel that runs
there is the op's. A reader then counts the slice's kernels of those
names, whatever they are called, so that a kernel that replaces one
changes only the time, never the work. The eager cells take the same
rule, so that the rooflines of both count alike.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

# (batch, heads, query length, key length, head size, causal)
Shape = Tuple[int, int, int, int, int, bool]


def attention(device: str, shapes: Sequence[Shape], seed: int) -> Dict[str, Callable[[], None]]:
    """{"attention_fwd": the op's forward at each shape, "attention_bwd": its
    backward}: inputs contiguous and in f32 as the cells run them, a key
    padding mask with every other row half padded."""
    import torch

    from dr4sr_tpu_torch.ops.attention import multihead_attention

    gen = torch.Generator(device=device).manual_seed(seed)
    calls = []
    for b, h, lq, lk, dh, causal in shapes:
        q = torch.randn(b, h, lq, dh, generator=gen, device=device, requires_grad=True)
        k, v = (torch.randn(b, h, lk, dh, generator=gen, device=device, requires_grad=True)
                for _ in range(2))
        pad = torch.zeros(b, lk, dtype=torch.bool, device=device)
        pad[::2, lk // 2:] = True
        out = multihead_attention(q, k, v, pad, causal)
        calls.append(((q, k, v, pad, causal), out, torch.ones_like(out)))

    def forward():
        for args, _, _ in calls:
            multihead_attention(*args)

    def backward():
        for (q, k, v, _, _), out, grad in calls:
            torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)

    return {"attention_fwd": forward, "attention_bwd": backward}


def kernels(probes: Dict[str, Callable[[], None]]) -> Dict[str, frozenset]:
    """The names of the kernels each probe launches, each probe warmed up
    once and then profiled alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, call in probes.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        out[label] = frozenset(e.name for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA
                               and not getattr(e, "is_user_annotation", False))
    return out
