"""GNN — item-transition-graph propagation feeding a SASRec encoder.

Port of ``dr4sr_tpu/models/gnn.py`` (reference ``model/gnn.py``): a weighted
item-transition graph from the val ('old') or train ('new') sequences with
a sliding window (weight 1/distance), symmetrised with self-loops and
normalised as ``D@A + A@D`` (D the inverse count of each row's nonzeros;
not D^-½AD^-½); the item table is propagated ``gnn_layer`` times through
it and averaged with layer 0, and the propagated rows replace the raw
lookup inside the causal transformer. Scoring and training use the raw
table (``model/basemodel.py:206``).

The graph is built on the host once (numpy and scipy) and rides in every
batch as ``edge_row``/``edge_col``/``edge_weight`` (the trainer's
``batch_extras``); on the device a layer is a gather and an ``index_add``
(``modules/graph_augmentation.py::propagate_step``). Under EP the item
table is row-sharded like every other model's; the propagation reads it
whole (``parallel.ep.full_table``, an all-gather over ``model``) on every
rank, and scores still come from the raw sharded table.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dr4sr_tpu_torch.models.base import item_embedding
from dr4sr_tpu_torch.models.registry import register_model
from dr4sr_tpu_torch.models.sasrec import SASRecEncoder
from dr4sr_tpu_torch.modules.graph_augmentation import Graph, propagate_mean
from dr4sr_tpu_torch.modules.layers import seq_pooling
from dr4sr_tpu_torch.parallel.ep import full_table


def build_transition_graph(
    seqs: np.ndarray,  # [N, L] post-padded
    seqlens: np.ndarray,  # [N]
    num_items: int,
    window: int = 2,
    drop_last: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edge list (row, col, weight) of the normalised adjacency, equal to
    the JAX package's element for element. ``drop_last`` reproduces the
    'old' graph's ``item_list_len -= 1`` (the val rows end with the train
    target).

    The pairs (item j → item j + d, weight 1/d, d = 1..window) are listed in
    the JAX loop's order (row, then j, then d), so scipy sums the repeated
    pairs in the same order."""
    import scipy.sparse as sp

    seqs = np.asarray(seqs)
    n = np.asarray(seqlens).astype(np.int64) - (1 if drop_last else 0)
    j = np.arange(seqs.shape[1])[None, :, None]
    dist = np.arange(1, window + 1)[None, None, :]
    i, j, k = np.nonzero(j + dist < n[:, None, None])  # C order: row, then j, then d
    if len(i) == 0:
        idx = np.arange(num_items)
        return idx, idx, np.ones(num_items, np.float32)
    rows, cols, data = seqs[i, j], seqs[i, j + k + 1], 1.0 / (k + 1.0)
    mat = sp.csc_matrix((data, (rows, cols)), shape=(num_items, num_items))
    mat = mat + mat.T + sp.eye(num_items)
    degree = np.asarray((mat > 0).sum(1)).ravel()
    with np.errstate(divide="ignore"):
        inv = np.nan_to_num(1.0 / degree, posinf=0.0)
    d = sp.diags(inv)
    norm = (d @ mat + mat @ d).tocoo()
    return (norm.row.astype(np.int32), norm.col.astype(np.int32),
            norm.data.astype(np.float32))


def batch_graph(batch: Dict[str, torch.Tensor], num_nodes: int) -> Graph:
    """The edges a batch carries, as a :class:`Graph`."""
    return Graph(batch["edge_row"], batch["edge_col"], batch["edge_weight"], num_nodes)


class GNNEncoder(nn.Module):
    """The JAX module's tree: ``item_embedding`` is the raw table (it
    scores), ``backbone`` a ``SASRecEncoder`` fed the propagated rows as
    ``seq_emb``. Its placeholder item table is never called, so flax creates
    no parameter for it; it is deleted here too, and the two trees map leaf
    for leaf."""

    reads_graph = True  # forward reads the batch's edges

    def __init__(self, num_items: int, embed_dim: int, max_seq_len: int, num_heads: int,
                 hidden_size: int, num_layers: int, gnn_layers: int, dropout: float,
                 activation: str = "gelu", layer_norm_eps: float = 1e-12,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.gnn_layers = gnn_layers
        self.num_items = num_items
        self.item_embedding = item_embedding(num_items, embed_dim, generator)
        self.backbone = SASRecEncoder(
            num_items=1, embed_dim=embed_dim, max_seq_len=max_seq_len, num_heads=num_heads,
            hidden_size=hidden_size, num_layers=num_layers, dropout=dropout,
            activation=activation, layer_norm_eps=layer_norm_eps, generator=generator)
        del self.backbone.item_embedding

    def forward(self, batch: Dict[str, torch.Tensor], need_pooling: bool = True) -> torch.Tensor:
        # the JAX package's ``propagate``: the mean of layers 0..gnn_layers,
        # over the whole table (gathered over ``model`` under EP)
        raw = full_table(self.item_embedding.weight, self.num_items)
        table = propagate_mean(batch_graph(batch, self.num_items), raw, self.gnn_layers)
        seq = batch["in_item_id"]
        inner = {"seq_emb": F.embedding(seq, table), "key_padding_mask": seq == 0,
                 "input_weight": batch.get("input_weight")}
        out = self.backbone(inner, need_pooling=False)
        if not need_pooling:
            return out
        return seq_pooling(out, batch["seqlen"], "origin" if self.training else "last")


@register_model("GNN")
class GNN:
    needs_graph = True

    @staticmethod
    def build(config: Dict[str, Any], num_items: int,
              generator: Optional[torch.Generator] = None, **kwargs) -> nn.Module:
        """As the JAX ``GNN.build``: activation and LayerNorm epsilon stay at
        their defaults (gelu, 1e-12) whatever the config says."""
        m = config["model"]
        return GNNEncoder(
            num_items=num_items,
            embed_dim=int(m["embed_dim"]),
            max_seq_len=int(config["data"]["max_seq_len"]),
            num_heads=int(m["head_num"]),
            hidden_size=int(m["hidden_size"]),
            num_layers=int(m["layer_num"]),
            gnn_layers=int(m.get("gnn_layer", 2)),
            dropout=float(m["dropout_rate"]),
            generator=generator,
        )
