"""Test helpers for the MoE layer's rows (``modules/moe.py``,
``ops/moe_permute.py``).

``routing`` groups random top-k assignments as ``DeepSeekMoE.forward``
does. The rest plants NaN in the rows of the layer's buffers that belong to
no group (rows from ``ends[-1]`` on), for the tests that show no value of
those rows reaches the layer's output or a gradient:
``planted_grouped_swiglu(fn)`` wraps ``moe.grouped_swiglu``: its input xs
and its output ys pass through :class:`Plant`, which writes NaN into those
rows of the tensor going forward and of its gradient coming back. So the
grouped products see NaN there, the combine sees NaN there, and the
products' backward and the dispatch's backward see NaN there. Each call's
group ends are kept; with ``plant=False`` the wrapper plants nothing (the
run that a planted one is held to).
"""

import torch


def routing(n, k, held, seed, device="cpu", masked=1 / 3):
    """``DeepSeekMoE.forward``'s grouping of random top-k assignments of n
    tokens, a share ``masked`` of the tokens masked and some assignments on
    experts held elsewhere: order, back (its inverse) and the group ends."""
    gen = torch.Generator().manual_seed(seed)
    local = torch.randint(0, held + 2, (n, k), generator=gen)  # held, held + 1: elsewhere
    mine = (local < held) & (torch.rand(n, 1, generator=gen) >= masked)
    key = torch.where(mine, local, held).flatten().to(device)
    order = torch.argsort(key, stable=True)
    ends = torch.searchsorted(key[order], torch.arange(1, held + 1, device=device)).to(
        torch.int32)
    back = torch.empty_like(order).scatter_(0, order, torch.arange(n * k, device=device))
    return order, back, ends


class Plant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ends):
        ctx.live = int(ends[-1])
        out = t.clone()
        out[ctx.live:] = float("nan")
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        grad[ctx.live:] = float("nan")
        return grad, None


def planted_grouped_swiglu(fn, seen, plant=True):
    """``fn`` (``grouped_swiglu``) with NaN planted past the last group of
    xs, ys and their gradients; each call's ``ends`` appended to ``seen``."""

    def wrapped(xs, row_w, w_gate, w_up, w_down, ends):
        seen.append(ends)
        if not plant:
            return fn(xs, row_w, w_gate, w_up, w_down, ends)
        ys = fn(Plant.apply(xs, ends), row_w, w_gate, w_up, w_down, ends)
        return Plant.apply(ys, ends)

    return wrapped
