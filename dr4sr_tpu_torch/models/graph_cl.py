"""Graph-contrastive models: SGL, SimGCL, NCL.

Port of ``dr4sr_tpu/models/graph_cl.py``: a SASRec backbone plus the item
side of each graph-CL objective on the item-transition graph that GNN
builds (the user-side terms of the reference's RecStudio classes act on no
parameter of a sequential model and are dropped, as in the JAX package).

Each model class gives the trainer's hooks:

* ``aux_draws(generator, batch, model_cfg, num_items)`` — the term's random
  draws (SGL's two edge masks, SimGCL's two sets of per-layer uniforms;
  NCL has none), so a caller can feed the same draws to two devices;
* ``aux_loss(module, batch, model_cfg, num_items, draws)`` — added to the
  main loss;
* ``refresh_state(trainer, nepoch)`` (NCL) — per-epoch state merged into
  the trainer's ``batch_extras``: k-means prototypes of the item table,
  initial rows drawn from the epoch as JAX draws them from ``PRNGKey(nepoch)``.

Like the reference's loaders, the CL terms do not mask the padded tail
rows of the last batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dr4sr_tpu_torch.models.gnn import batch_graph
from dr4sr_tpu_torch.models.registry import register_model
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.modules.graph_augmentation import (
    edge_dropout,
    fit_prototypes,
    info_nce_all,
    kmeans_init,
    propagate_layers,
    propagate_mean,
    sample_keep,
)

Batch = Dict[str, torch.Tensor]


def _last_target_items(batch: Batch) -> torch.Tensor:
    """[B] the final supervised item of each row (per-position targets [B, L])."""
    item_id = batch["item_id"]
    if item_id.dim() == 1:
        return item_id
    idx = torch.clamp(batch["seqlen"] - 1, 0, item_id.shape[1] - 1)
    return torch.gather(item_id, 1, idx[:, None])[:, 0]


def _two_view_item_cl(module, batch: Batch, model_cfg, num_items: int, make_views):
    """SGL's and SimGCL's objective: two propagated views of the item table
    (``make_views(graph, table)``, where the two models differ), cosine
    InfoNCE on the batch's last targets with catalog negatives."""
    table = module.item_embedding.weight[:num_items]
    v1, v2 = make_views(batch_graph(batch, num_items), table)
    items = _last_target_items(batch)
    t = float(model_cfg.get("ssl_temperature", 0.2))
    return float(model_cfg.get("ssl_weight", 0.1)) * info_nce_all(v1[items], v2[items], v2[1:], t)


class _GraphCL(SASRec):
    needs_graph = True

    @staticmethod
    def aux_draws(generator: Optional[torch.Generator], batch: Batch, model_cfg,
                  num_items: int):
        return None


@register_model("SGL")
class SGL(_GraphCL):
    """SASRec + SGL item CL: two edge-dropout views of the transition graph
    (reference ``SGLAugmentation``, ``module/data_augmentation.py:407-455``)."""

    @staticmethod
    def aux_draws(generator, batch, model_cfg, num_items):
        """Two [E] keep masks, Bernoulli(1 − ``ssl_ratio``)."""
        ratio = float(model_cfg.get("ssl_ratio", 0.1))
        e, device = batch["edge_weight"].shape[0], batch["edge_weight"].device
        return [sample_keep(generator, e, ratio, device) for _ in range(2)]

    @staticmethod
    def aux_loss(module, batch, model_cfg, num_items, draws):
        ratio = float(model_cfg.get("ssl_ratio", 0.1))
        layers = int(model_cfg.get("gnn_layer", 2))
        return _two_view_item_cl(module, batch, model_cfg, num_items, lambda g, table: [
            propagate_mean(edge_dropout(g, ratio, keep), table, layers) for keep in draws])


@register_model("SimGCL")
class SimGCL(_GraphCL):
    """SASRec + SimGCL item CL: two noise-perturbed propagations (reference
    ``SimGCLAugmentation``, ``module/data_augmentation.py:528-575``)."""

    @staticmethod
    def aux_draws(generator, batch, model_cfg, num_items):
        """Two [gnn_layer, num_items, D] uniforms, one slice a layer."""
        layers = int(model_cfg.get("gnn_layer", 2))
        shape = (layers, num_items, int(model_cfg["embed_dim"]))
        device = batch["edge_weight"].device
        return [torch.rand(shape, generator=generator, device=device) for _ in range(2)]

    @staticmethod
    def aux_loss(module, batch, model_cfg, num_items, draws):
        eps = float(model_cfg.get("noise_eps", 0.1))
        layers = int(model_cfg.get("gnn_layer", 2))
        return _two_view_item_cl(module, batch, model_cfg, num_items, lambda g, table: [
            propagate_mean(g, table, layers, noise=u, noise_eps=eps) for u in draws])


@register_model("NCL")
class NCL(_GraphCL):
    """SASRec + NCL item CL: a structure term (layer 2k against layer 0 of
    the propagation) and a semantic term against k-means prototypes
    refreshed every epoch (reference ``NCLAugmentation``,
    ``module/data_augmentation.py:457-526``; faiss → Lloyd k-means)."""

    @staticmethod
    def refresh_state(trainer, nepoch: int) -> Dict[str, torch.Tensor]:
        k = int(trainer.config["model"].get("num_clusters", 64))
        table = trainer.rec.module.item_embedding.weight.detach()[: trainer.num_items]
        proto = fit_prototypes(table, k, kmeans_init(trainer.num_items - 1, k, nepoch))
        return {"proto_centroids": proto.centroids, "proto_assign": proto.assign}

    @staticmethod
    def aux_loss(module, batch, model_cfg, num_items, draws):
        table = module.item_embedding.weight[:num_items]
        hyper = int(model_cfg.get("hyper_layers", 1))
        layers = propagate_layers(batch_graph(batch, num_items), table, 2 * hyper)
        center, context = layers[0], layers[2 * hyper]
        items = _last_target_items(batch)
        t = float(model_cfg.get("ssl_temperature", 0.2))
        structure = info_nce_all(context[items], center[items], center[1:], t)
        cents, assign = batch["proto_centroids"], batch["proto_assign"]
        semantic = info_nce_all(center[items], cents[assign[items]], cents, t)
        return (float(model_cfg.get("ssl_weight", 0.1)) * structure
                + float(model_cfg.get("proto_weight", 0.1)) * semantic)

