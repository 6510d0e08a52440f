"""FMLP — frequency-domain MLP sequence encoder.

Port of ``dr4sr_tpu/models/fmlp.py``: item + position embeddings →
LayerNorm → dropout → FMLP layers (``modules/layers.py::FMLPEncoder``) →
the query is always the **last position**, so FMLP's rows are pre-padded
(padding in front):

* :func:`expand_prefix_rows` — the train rows become one row per prefix,
  pre-padded, each with its single next-item target (``prefix_training``);
* :func:`pre_pad_batch` — eval batches (and train batches that were not
  expanded) move their padding to the front on the host (``pre_padding``).

No attention. Under bf16 autocast the FFT runs in f32 (cuFFT has no bf16),
unlike the JAX package's bf16 einsum, so bf16 results are not JAX's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from dr4sr_tpu_torch.data.dataset import RowData
from dr4sr_tpu_torch.models.base import item_embedding
from dr4sr_tpu_torch.models.registry import register_model
from dr4sr_tpu_torch.modules.layers import FMLPEncoder, normal_
from dr4sr_tpu_torch.parallel.ep import embed_lookup


def expand_prefix_rows(rows: RowData) -> RowData:
    """Per-prefix train rows (the reference's ``dataset_transform.ipynb``
    cell 3): train row ``r`` becomes ``seqlen[r]`` rows, the i-th holding
    the pre-padded prefix ``seq[:i+1]``, the single target ``target[i]`` and
    label 1."""
    L = rows.max_seq_len
    lens = rows.seqlen.astype(np.int64)
    total = int(lens.sum())
    # output row r comes from source row src[r] with prefix length m[r]
    src = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    offsets = np.repeat(np.cumsum(lens) - lens, lens)
    m = (np.arange(total, dtype=np.int64) - offsets + 1).astype(np.int32)
    k = np.arange(L, dtype=np.int32)[None, :] - (L - m[:, None])  # source column
    in_item = np.where(k >= 0, rows.in_item_id[src[:, None], np.maximum(k, 0)], 0)
    return RowData(
        user_id=rows.user_id[src].astype(np.int32),
        in_item_id=in_item.astype(np.int32),
        item_id=rows.item_id[src, m - 1].astype(np.int32),
        seqlen=m,
        label=np.ones(total, np.float32),
        domain_id=rows.domain_id[src].astype(np.int32),
    )


def pre_pad_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Move the padding of every [B, L] sequence field (``in_item_id``,
    ``item_id``, ``label``) from the back to the front; other fields, and
    ``user_hist``, stay as they are."""
    out = dict(batch)
    L = batch["in_item_id"].shape[1]
    src = np.arange(L)[None, :] - (L - batch["seqlen"]).astype(np.int64)[:, None]
    inside = src >= 0
    src = np.clip(src, 0, L - 1)
    for key in ("in_item_id", "item_id", "label"):
        arr = batch.get(key)
        if arr is not None and arr.ndim == 2 and arr.shape[1] == L:
            out[key] = np.where(inside, np.take_along_axis(arr, src, axis=1), 0)
    return out


class FMLPQueryEncoder(nn.Module):
    def __init__(
        self,
        num_items: int,
        embed_dim: int,
        max_seq_len: int,
        num_layers: int,
        dropout: float,
        layer_norm_eps: float = 1e-12,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.item_embedding = item_embedding(num_items, embed_dim, generator)
        self.position_emb = nn.Embedding(max_seq_len, embed_dim)
        normal_(self.position_emb.weight, generator)
        self.input_norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps)
        self.input_dropout = nn.Dropout(dropout)
        self.encoder = FMLPEncoder(num_layers, max_seq_len, embed_dim, dropout, layer_norm_eps,
                                   generator)

    def forward(self, batch: Dict[str, torch.Tensor], need_pooling: bool = True) -> torch.Tensor:
        seq = batch["in_item_id"]
        pos = torch.arange(seq.shape[1], device=seq.device)
        x = self.input_norm(embed_lookup(self.item_embedding, seq) + self.position_emb(pos)[None])
        out = self.encoder(self.input_dropout(x))
        return out[:, -1]  # the last (pre-padded) position, in train and eval


@register_model("FMLP")
class FMLP:
    pre_padding = True  # eval batches roll their padding to the front
    prefix_training = True  # train rows expand to per-prefix rows

    @staticmethod
    def build(config: Dict[str, Any], num_items: int,
              generator: Optional[torch.Generator] = None, **kwargs) -> nn.Module:
        m = config["model"]
        return FMLPQueryEncoder(
            num_items=num_items,
            embed_dim=int(m["embed_dim"]),
            max_seq_len=int(config["data"]["max_seq_len"]),
            num_layers=int(m["layer_num"]),
            dropout=float(m["dropout_rate"]),
            layer_norm_eps=float(m.get("layer_norm_eps", 1e-12)),
            generator=generator,
        )
