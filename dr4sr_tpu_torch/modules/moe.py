"""DeepSeekMoE (arXiv:2401.06066; DeepSeek-V2, arXiv:2405.04434 §2.2) as one
device's share of an expert-parallel layer.

The router scores every token against all ``n_routed`` experts (a linear
map in f32, softmax over all of them), keeps the greedy top-k, and weighs
each kept expert by its probability (renormalised over the k only with
``norm_topk_prob``) times ``routed_scaling``. This layer holds experts
``expert_offset`` .. ``expert_offset + experts_held - 1`` of them and
computes their part of the result, Σ over the token's kept experts that it
holds of weight · SwiGLU_e(x), plus the shared experts (one SwiGLU of
``n_shared`` × the expert width) that every token passes through. What the
experts held elsewhere add is left out, as on one device of an
expert-parallel deployment before its exchange; the shares of all the
devices, with the shared experts counted once, add up to the whole layer.

With ``fold_foreign``, an assignment to an expert held elsewhere is
computed by held expert ``expert_offset + (e - expert_offset) mod
experts_held`` instead of being left out. That stands in for the rows the
other devices' tokens send to this device's experts: on average the held
experts then take N·k rows, as one device of an expert-parallel layer does
after its exchange, without the exchange. It is a different function from
the published layer, made for measuring one device's share.

On the device and without a host synchronisation (spans ``moe.route``,
``moe.experts``, ``moe.combine``, ``utils/spans.py``):

1. route: the router and top-k; each (token, slot) assignment gets the key
   of its held expert, or ``experts_held`` for an expert held elsewhere
   (unless folded) or a masked (pad) token; one stable sort of the keys
   groups the assignments by expert, ``searchsorted`` gives each group's
   end, and the tokens are gathered in that order, cast to the compute
   dtype (``ops/moe_permute.py::dispatch_rows``). The buffer has N·k rows,
   the most the held experts could be given, so no token is ever dropped.
2. experts: gate, up and down of the held experts as grouped products over
   those groups (``torch._grouped_mm`` with the device's group ends, in the
   autocast dtype); rows past the last group are never computed.
   Each row's hidden activation is multiplied by its weight before the
   down projection.
3. combine: each token's rows in the groups summed in f32
   (``ops/moe_permute.py::combine_rows``), plus the shared experts.

No value of a row past the last group reaches the output or a gradient: on
the CPU the plain chain zeroes those rows, on the card the kernels neither
read them nor write their gradients.

The load counters ``moe.assignments`` (per held expert) and ``moe.tokens``
are added on the device while a profiler session is open.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dr4sr_tpu_torch.modules.mla import SwiGLU, weight
from dr4sr_tpu_torch.ops.moe_permute import combine_rows, dispatch_rows
from dr4sr_tpu_torch.utils.spans import count, span


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    kind = x.device.type
    return torch.get_autocast_dtype(kind) if torch.is_autocast_enabled(kind) else x.dtype


def grouped_swiglu(xs: torch.Tensor, row_w: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Rows ``ends[e-1]:ends[e]`` of ``xs`` [M, D] through expert e's SwiGLU
    (weights [E, out, in]), each row's hidden activation times its weight
    ``row_w`` [M] before the down projection (which is linear); rows from
    ``ends[-1]`` on are undefined."""
    dt = xs.dtype

    def mm(a, w):
        return torch._grouped_mm(a, w.to(dt).transpose(-2, -1), offs=ends)

    h = F.silu(mm(xs, w_gate)) * mm(xs, w_up)
    return mm(h * row_w[:, None].to(dt), w_down)


class DeepSeekMoE(nn.Module):
    def __init__(self, hidden: int, n_routed: int, top_k: int, expert_width: int,
                 n_shared: int, experts_held: int, expert_offset: int, norm_topk_prob: bool,
                 routed_scaling: float, generator: Optional[torch.Generator],
                 fold_foreign: bool = False) -> None:
        super().__init__()
        if not 0 <= expert_offset <= n_routed - experts_held:
            raise ValueError(f"experts {expert_offset}..{expert_offset + experts_held - 1} "
                             f"are not among the {n_routed} routed experts")
        self.n_routed, self.top_k = n_routed, top_k
        self.experts_held, self.expert_offset = experts_held, expert_offset
        self.norm_topk_prob, self.routed_scaling = norm_topk_prob, routed_scaling
        self.fold_foreign = fold_foreign
        self.gate = weight(n_routed, hidden, generator)
        self.w_gate = weight(expert_width, hidden, generator, experts_held)
        self.w_up = weight(expert_width, hidden, generator, experts_held)
        self.w_down = weight(hidden, expert_width, generator, experts_held)
        self.shared = SwiGLU(hidden, expert_width * n_shared, generator)

    def forward(self, x: torch.Tensor, token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [..., D]; ``token_mask`` [...] bool, False for a token (a pad
        position) that no routed expert takes."""
        shape = x.shape
        x = x.reshape(-1, shape[-1]).contiguous()
        n, k, held = x.shape[0], self.top_k, self.experts_held
        with span("moe.route"):
            with torch.autocast(x.device.type, enabled=False):
                probs = F.linear(x.float(), self.gate.float()).softmax(dim=-1)
            w, idx = torch.topk(probs, k, dim=-1)
            if self.norm_topk_prob:
                w = w / w.sum(dim=-1, keepdim=True)
            w = w * self.routed_scaling
            local = idx - self.expert_offset
            if self.fold_foreign:
                local = local.remainder(held)
            mine = (local >= 0) & (local < held)
            if token_mask is not None:
                mine = mine & token_mask.reshape(n, 1)
            key = torch.where(mine, local, held).flatten()
            order = torch.argsort(key, stable=True)  # assignment i of the groups is order[i]
            ends = torch.searchsorted(key[order], torch.arange(
                1, held + 1, device=x.device, dtype=key.dtype)).to(torch.int32)
            # assignment a is row back[a] of the groups
            back = torch.empty_like(order).scatter_(0, order, torch.arange(
                n * k, device=x.device))
            xs = dispatch_rows(x, order, back, k, ends, _compute_dtype(x))
            count("moe.assignments", torch.diff(ends, prepend=ends.new_zeros(1)))
            count("moe.tokens", (token_mask if token_mask is not None
                                 else x.new_ones(n, dtype=torch.bool)).sum())
        with span("moe.experts"):
            # a row past the last group takes no weight (nor gradient: its
            # hidden activation is undefined)
            live = torch.arange(n * k, device=x.device) < ends[-1]
            row_w = torch.where(live, w.flatten()[order], 0.0)
            ys = grouped_swiglu(xs, row_w, self.w_gate, self.w_up, self.w_down, ends)
        with span("moe.combine"):
            # back to (token, slot) order, each token's k rows summed in f32
            y = combine_rows(ys, back, k, ends) + self.shared(x)
        return y.reshape(shape)
