"""Flat-parameter utilities.

Port of ``dr4sr_tpu/utils/reparam.py`` (the reference's ``ReparamModule``,
``utils/reparam_module.py``: every parameter of a module flattened into one
vector, and a forward with injected parameters). The parameters are a dict
of tensors or an ``nn.Module``'s named parameters, in their own order; the
functional forward is ``torch.func.functional_call``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple, Union

import torch
from torch import nn

Params = Union[Mapping[str, torch.Tensor], nn.Module]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def flatten_params(
    params: Params,
) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Dict[str, torch.Tensor]]]:
    """(flat vector, unravel): the vector concatenates every tensor,
    flattened, in the dict's order; ``unravel`` maps a vector of that length
    back to a dict of views of it with the original names and shapes."""
    named = _named(params)
    shapes = [(name, t.shape, t.numel()) for name, t in named.items()]
    flat = torch.cat([t.reshape(-1) for t in named.values()]) if named else torch.zeros(0)

    def unravel(vector: torch.Tensor) -> Dict[str, torch.Tensor]:
        if vector.numel() != flat.numel():
            raise ValueError(f"a flat vector of {vector.numel()} values for {flat.numel()} "
                             f"parameters")
        out, offset = {}, 0
        for name, shape, n in shapes:
            out[name] = vector[offset:offset + n].view(shape)
            offset += n
        return out

    return flat, unravel


def functional_apply(
    module: nn.Module, unravel: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    flat: torch.Tensor, *args, **kwargs,
):
    """``module``'s forward with its parameters taken from ``flat``."""
    return torch.func.functional_call(module, unravel(flat), args, kwargs)


def flat_param_count(params: Params) -> int:
    return sum(t.numel() for t in _named(params).values())
