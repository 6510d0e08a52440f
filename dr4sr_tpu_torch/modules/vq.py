"""Vector-quantisation layers.

Port of ``dr4sr_tpu/modules/vq.py`` (the reference's dormant VQ stack,
``module/layers.py:237-385``): a single-codebook
:class:`VanillaVectorQuantizer` and the residual multi-level
:class:`VectorQuantizer`, with straight-through estimators (``detach()``
where JAX has ``stop_gradient``) and EMA-free commitment losses. No model
of either package uses them yet. The levels are sub-modules named
``level_<i>``, so ``convert.params_from_jax`` carries ``level_i/codebook``
over as it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dr4sr_tpu_torch.modules.graph_augmentation import nearest
from dr4sr_tpu_torch.modules.layers import normal_


class VanillaVectorQuantizer(nn.Module):
    def __init__(self, num_codes: int, embed_dim: int, commitment_cost: float = 0.25,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.commitment_cost = commitment_cost
        self.codebook = nn.Parameter(torch.empty(num_codes, embed_dim))
        normal_(self.codebook, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(quantised, codes, loss) of x [..., D]."""
        codes = nearest(x.detach().reshape(-1, x.shape[-1]), self.codebook.detach())
        codes = codes.reshape(x.shape[:-1])
        quant = self.codebook[codes]
        codebook_loss = ((quant - x.detach()) ** 2).mean()
        commit_loss = ((x - quant.detach()) ** 2).mean()
        loss = codebook_loss + self.commitment_cost * commit_loss
        return x + (quant - x).detach(), codes, loss  # straight-through


class VectorQuantizer(nn.Module):
    """Residual VQ: each level quantises the residual of the one before."""

    def __init__(self, num_codes: int, embed_dim: int, num_levels: int = 2,
                 commitment_cost: float = 0.25,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.num_levels = num_levels
        for level in range(num_levels):
            self.add_module(f"level_{level}", VanillaVectorQuantizer(
                num_codes, embed_dim, commitment_cost, generator))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(the levels' quantised sum, codes [..., num_levels], summed loss)."""
        residual, total, losses, codes = x, torch.zeros_like(x), [], []
        for level in range(self.num_levels):
            q, c, loss = getattr(self, f"level_{level}")(residual)
            residual = residual - q.detach()
            total = total + q
            losses.append(loss)
            codes.append(c)
        return total, torch.stack(codes, dim=-1), torch.stack(losses).sum()
