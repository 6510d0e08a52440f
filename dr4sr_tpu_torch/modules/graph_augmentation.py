"""Graph and intent contrastive augmentation, and k-means.

Port of ``dr4sr_tpu/modules/graph_augmentation.py``: SGL's edge/node
dropout, SimGCL's noisy propagation, NCL's structure and prototype terms,
ICLRec's instance and intent terms, the similarity-driven sequence
augmentations, and the Lloyd k-means that replaces the reference's faiss.

As in the JAX package, a graph is a fixed-shape COO edge list ``(row, col,
weight)``: dropout zeroes weights instead of removing edges. A propagation
layer is a gather of the source rows (``index_select``) and a segment sum
over the target rows (``index_add``, atomic adds on the card); the
backward of each is the other.

Every random augmentation is a function of its draws, as
``modules/augmentation.py`` is, so the tests feed JAX's draws in:

* :func:`edge_dropout` and :func:`node_dropout` take their Bernoulli keep
  masks ([E] and [num_nodes] bool);
* :func:`propagate_mean` takes SimGCL's per-layer uniforms ``noise``
  ([num_layers, N, D]);
* :func:`kmeans` takes its initial row indices (JAX draws them with
  ``jax.random.choice(..., replace=False)``; :func:`kmeans_init` draws
  them from a seed);
* :func:`item_substitute` and :func:`item_insert` take their uniforms
  ([B, L]);
* :func:`iclrec_cl_losses` takes the two views' augmentation draws.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from dr4sr_tpu_torch.modules.augmentation import Draws, apply_draws
from dr4sr_tpu_torch.modules.layers import seq_pooling
from dr4sr_tpu_torch.modules.losses import _normalize, info_nce_loss

_NEG = -1e30


# ---------------------------------------------------------------------------
# k-means (faiss replacement)
# ---------------------------------------------------------------------------


def squared_distances(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N, k] ``|x|² − 2x·cᵀ + |c|²``, written out as the JAX package does."""
    return ((x ** 2).sum(-1, keepdim=True) - 2 * x @ centroids.T
            + (centroids ** 2).sum(-1)[None, :])


def nearest(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N] index of each row's nearest centroid (first on ties)."""
    return torch.argmin(squared_distances(x, centroids), dim=-1)


def lloyd_update(x: torch.Tensor, assign: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The mean of each cluster's rows; an empty cluster keeps its centroid."""
    k = centroids.shape[0]
    sums = torch.zeros_like(centroids).index_add_(0, assign, x)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(
        0, assign, torch.ones_like(x[:, 0]))
    new = sums / counts.clamp_min(1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centroids)


def kmeans_init(n: int, k: int, seed: int) -> torch.Tensor:
    """``k`` distinct row indices of ``n``, drawn on the CPU from ``seed``
    (the JAX package's ``kmeans`` draws them from ``PRNGKey(seed)``)."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(int(seed)))[:k]


@torch.no_grad()
def kmeans(x: torch.Tensor, k: int, init_idx: torch.Tensor,
           iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm from the rows ``init_idx`` of x [N, D]: (centroids
    [k, D], assign [N]). No host synchronisation: the loop has a fixed
    count, as JAX's ``fori_loop``."""
    centroids = x[init_idx.to(x.device)]
    for _ in range(iters):
        centroids = lloyd_update(x, nearest(x, centroids), centroids)
    return centroids, nearest(x, centroids)


class KMeansState(NamedTuple):
    centroids: torch.Tensor  # [k, D]
    assign: torch.Tensor  # [N]


def fit_prototypes(embeddings: torch.Tensor, k: int, init_idx: torch.Tensor,
                   iters: int = 20) -> KMeansState:
    """k-means over ``embeddings[1:]`` (the PAD row left out, as the
    reference's ``run_kmeans`` trains), then every row assigned, PAD
    included. ``init_idx`` indexes ``embeddings[1:]``."""
    cents, _ = kmeans(embeddings[1:], k, init_idx, iters)
    return KMeansState(cents, nearest(embeddings.detach(), cents))


# ---------------------------------------------------------------------------
# graph perturbations (fixed-shape edge lists)
# ---------------------------------------------------------------------------


class Graph(NamedTuple):
    row: torch.Tensor  # [E] target rows
    col: torch.Tensor  # [E] source rows
    weight: torch.Tensor  # [E]
    num_nodes: int


def edge_dropout(g: Graph, dropout_ratio: float, keep: torch.Tensor) -> Graph:
    """Zero the weights of the edges whose ``keep`` [E] is False and scale
    the others by 1/(1 − ratio) (reference ``EdgeDropout``)."""
    rate = 1.0 - dropout_ratio
    return g._replace(weight=torch.where(keep, g.weight / rate, 0.0))


def node_dropout(g: Graph, dropout_ratio: float, keep: torch.Tensor) -> Graph:
    """Zero every edge incident to a node whose ``keep`` [num_nodes] is
    False (reference ``NodeDropout``)."""
    rate = 1.0 - dropout_ratio
    alive = keep[g.row] & keep[g.col]
    return g._replace(weight=torch.where(alive, g.weight / rate, 0.0))


def sample_keep(generator: Optional[torch.Generator], n: int, dropout_ratio: float,
                device) -> torch.Tensor:
    """[n] Bernoulli(1 − ratio) keep mask, as JAX's ``bernoulli(rng, keep)``."""
    return torch.rand(n, generator=generator, device=device) < 1.0 - dropout_ratio


def propagate_step(g: Graph, emb: torch.Tensor) -> torch.Tensor:
    """One layer: ``out[row] += weight · emb[col]`` over the edges."""
    msgs = emb.index_select(0, g.col) * g.weight[:, None]
    return torch.zeros((g.num_nodes, emb.shape[1]), dtype=msgs.dtype,
                       device=emb.device).index_add(0, g.row, msgs)


def propagate_mean(g: Graph, embeddings: torch.Tensor, num_layers: int,
                   noise: Optional[torch.Tensor] = None, noise_eps: float = 0.0) -> torch.Tensor:
    """LightGCN-style propagation; the mean over layers 0..L. ``noise``
    ([num_layers, N, D] uniforms in [0, 1)) adds SimGCL's perturbation to
    every layer's output."""
    acc = emb = embeddings
    for layer in range(num_layers):
        emb = propagate_step(g, emb)
        if noise is not None and noise_eps > 0.0:
            # SimGCL: Δ = sign(e) ⊙ (row-L2-normalised uniforms) · ε
            emb = emb + torch.sign(emb) * _normalize(noise[layer]) * noise_eps
        acc = acc + emb
    return acc / (num_layers + 1)


def propagate_layers(g: Graph, embeddings: torch.Tensor, num_layers: int) -> list:
    """Every layer's embeddings [0..L] (NCL reads layer 2k)."""
    out = [embeddings]
    for _ in range(num_layers):
        out.append(propagate_step(g, out[-1]))
    return out


# ---------------------------------------------------------------------------
# InfoNCE 'all' mode (cosine, catalog negatives)
# ---------------------------------------------------------------------------


def info_nce_all(rep_i: torch.Tensor, rep_j: torch.Tensor, all_reps: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    """``neg_type='all'``: logsumexp over the whole catalog minus the
    positive's similarity, cosine (reference ``InfoNCELoss`` ``:382-402``)."""
    rep_i, rep_j, all_reps = _normalize(rep_i), _normalize(rep_j), _normalize(all_reps)
    sim_ij = rep_i @ all_reps.T / temperature  # [B, N]
    sim_ii = (rep_i * rep_j).sum(-1) / temperature  # [B]
    return (torch.logsumexp(sim_ij.float(), dim=-1) - sim_ii.float()).mean()


# ---------------------------------------------------------------------------
# user-item augmentation models (functional)
# ---------------------------------------------------------------------------


def _user_item_cl(view1, view2, num_users, user_ids, item_ids, temperature):
    u1, i1 = view1[:num_users], view1[num_users:]
    u2, i2 = view2[:num_users], view2[num_users:]
    return (info_nce_all(u1[user_ids], u2[user_ids], u2[1:], temperature)
            + info_nce_all(i1[item_ids], i2[item_ids], i2[1:], temperature))


def sgl_cl_loss(g: Graph, embeddings: torch.Tensor, num_users: int, user_ids: torch.Tensor,
                item_ids: torch.Tensor, keep: Sequence[torch.Tensor], num_layers: int = 2,
                aug_type: str = "ED", ssl_ratio: float = 0.1,
                temperature: float = 0.2) -> torch.Tensor:
    """SGL: two dropout-perturbed views of the user-item graph (``keep``:
    two edge masks for 'ED'/'RW', two node masks for 'ND'), cosine InfoNCE
    with catalog negatives (reference ``SGLAugmentation``)."""
    drop = edge_dropout if aug_type in ("ED", "RW") else node_dropout
    views = [propagate_mean(drop(g, ssl_ratio, m), embeddings, num_layers) for m in keep]
    return _user_item_cl(*views, num_users, user_ids, item_ids, temperature)


def ncl_cl_losses(layer_embeddings: list, num_users: int, user_ids: torch.Tensor,
                  item_ids: torch.Tensor, user_proto: KMeansState, item_proto: KMeansState,
                  hyper_layers: int = 1, alpha: float = 1.0,
                  temperature: float = 0.2) -> Dict[str, torch.Tensor]:
    """NCL: structure CL (layer 2k against layer 0) and semantic CL against
    the prototypes (reference ``NCLAugmentation``)."""
    center = layer_embeddings[0]
    context = layer_embeddings[hyper_layers * 2]
    uc, ic = center[:num_users], center[num_users:]
    ux, ix = context[:num_users], context[num_users:]
    structure = (info_nce_all(ux[user_ids], uc[user_ids], uc[1:], temperature)
                 + alpha * info_nce_all(ix[item_ids], ic[item_ids], ic[1:], temperature))
    semantic = (
        info_nce_all(uc[user_ids], user_proto.centroids[user_proto.assign[user_ids]],
                     user_proto.centroids, temperature)
        + alpha * info_nce_all(ic[item_ids], item_proto.centroids[item_proto.assign[item_ids]],
                               item_proto.centroids, temperature))
    return {"structure_cl_loss": structure, "semantic_cl_loss": semantic}


def simgcl_cl_loss(g: Graph, embeddings: torch.Tensor, num_users: int, user_ids: torch.Tensor,
                   item_ids: torch.Tensor, noise: Sequence[torch.Tensor], num_layers: int = 2,
                   noise_eps: float = 0.1, temperature: float = 0.2) -> torch.Tensor:
    """SimGCL: two noise-perturbed propagations (``noise``: two
    [num_layers, N, D] uniforms), catalog-negative InfoNCE."""
    views = [propagate_mean(g, embeddings, num_layers, noise=u, noise_eps=noise_eps)
             for u in noise]
    return _user_item_cl(*views, num_users, user_ids, item_ids, temperature)


def iclrec_cl_losses(
    encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # -> [B, L, D]
    seq: torch.Tensor,
    seqlen: torch.Tensor,
    seq_out_pooled: torch.Tensor,  # [B, D] mean-pooled reps; no gradient is taken through them
    intent_state: KMeansState,
    num_items: int,
    views: Tuple[Draws, Draws],
    temperature: float = 1.0,
    valid: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """ICLRec: instance CL between two augmented views (``views``: their
    draws, the augmentations at their default ratios with mask id
    ``num_items``), and intent CL against each row's nearest k-means
    centroid with same-intent de-noising (reference ``ICLRecAugmentation``)."""
    outs = []
    for draws in views:
        s, n = apply_draws(seq, seqlen, draws, mask_id=num_items)
        outs.append(seq_pooling(encode_fn(s, n), n, "mean"))
    out_i, out_j = outs
    instance = 0.5 * (info_nce_loss(out_i, out_j, temperature, valid=valid)
                      + info_nce_loss(out_j, out_i, temperature, valid=valid))
    intent_ids = nearest(seq_out_pooled.detach().float(), intent_state.centroids)
    seq2intents = intent_state.centroids[intent_ids]
    intent = 0.5 * (
        info_nce_loss(out_i, seq2intents, temperature, instance_labels=intent_ids, valid=valid)
        + info_nce_loss(out_j, seq2intents, temperature, instance_labels=intent_ids,
                        valid=valid))
    return {"instance_cl_loss": instance, "intent_cl_loss": intent}


# ---------------------------------------------------------------------------
# online item similarity + similarity-driven sequence augmentations
# ---------------------------------------------------------------------------


@torch.no_grad()
def online_top1_similar(item_embeddings: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
    """The most similar other item by inner product (reference
    ``OnlineItemSimilarity``; its min-max normalisation does not move the
    argmax). ``item_ids`` are not PAD."""
    table = item_embeddings[1:]  # drop PAD
    flat = (item_ids - 1).reshape(-1)
    sim = table[flat] @ table.T
    sim[torch.arange(flat.shape[0], device=sim.device), flat] = _NEG
    return (torch.argmax(sim, dim=-1) + 1).reshape(item_ids.shape)


def _chosen(seq: torch.Tensor, seqlen: torch.Tensor, rate: float, u: torch.Tensor):
    """(count [B], chosen [B, L]): the ``max(1, int(rate·len))`` real
    positions with the smallest uniforms ``u``."""
    count = torch.clamp((rate * seqlen.to(torch.float32)).to(seqlen.dtype), min=1)
    pos = torch.arange(seq.shape[1], device=seq.device)[None, :]
    u = torch.where(pos < seqlen[:, None], u, float("inf"))
    rank = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1, stable=True)
    return count, rank < count[:, None]


def item_substitute(seq: torch.Tensor, seqlen: torch.Tensor, item_embeddings: torch.Tensor,
                    u: torch.Tensor, substitute_rate: float = 0.1):
    """Replace ``max(1, rate·len)`` random positions (the smallest uniforms
    ``u`` [B, L]) with their top-1 similar item (reference
    ``Item_Substitute``)."""
    _, chosen = _chosen(seq, seqlen, substitute_rate, u)
    similar = online_top1_similar(item_embeddings, torch.where(seq == 0, 1, seq))
    return torch.where(chosen & (seq != 0), similar, seq), seqlen


def item_insert(seq: torch.Tensor, seqlen: torch.Tensor, item_embeddings: torch.Tensor,
                u: torch.Tensor, insert_rate: float = 0.4):
    """Insert the top-1 similar item before ``max(1, rate·len)`` random
    positions (reference ``Item_Insert``), then keep the most recent L
    tokens (truncated from the left, as the reference's pipeline)."""
    b, l = seq.shape
    ins_len, chosen = _chosen(seq, seqlen, insert_rate, u)
    chosen = chosen & (seq != 0)
    similar = online_top1_similar(item_embeddings, torch.where(seq == 0, 1, seq))
    pos = torch.arange(l, device=seq.device)[None, :]
    # element j goes to j + (#chosen before j), after its own inserted partner
    chosen_i = chosen.to(seq.dtype)
    before = torch.cumsum(chosen_i, dim=1) - chosen_i
    width = 2 * l  # the widest before truncation
    out = torch.zeros((b, width), dtype=seq.dtype, device=seq.device)
    out.scatter_add_(1, pos + before, torch.where(chosen, similar, 0))
    out.scatter_add_(1, pos + before + chosen_i, torch.where(pos < seqlen[:, None], seq, 0))
    total = seqlen + ins_len
    out = torch.where(torch.arange(width, device=seq.device)[None, :] < total[:, None], out, 0)
    src = torch.clamp(total - l, min=0)[:, None] + pos
    return torch.gather(out, 1, torch.clamp(src, 0, width - 1)), torch.clamp(total, max=l)
