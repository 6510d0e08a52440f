"""Plain PyTorch SASRec (Kang & McAuley, arXiv:1808.09781) as DR4SR trains
and serves it: item and learned position embeddings, dropout, a stack of
post-norm causal transformer layers with a key-padding mask, per-position
BCE against one uniform negative, Adam; in eval the last real position's
state scores the whole catalog and the top-k unseen items are served.

The weights are drawn from the seed in the port's order (item table,
positions, then each layer's qkv, out_proj, ffn1, ffn2), the negatives from
a device generator seeded ``seed + 1`` and the dropout masks from the
default generator seeded ``seed + 1``, in the order the port's training
step draws them, so the reference takes the same step from the same
inputs without reading anything the program made. Float32, TF32 off
unless :func:`plain.precision` says otherwise. Imports neither the port
nor JAX.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch
import torch.nn.functional as F

from reference import plain


def init_params(cfg: dict, seed: int) -> Dict[str, torch.Tensor]:
    """The initial weights, by the port's parameter names, on the CPU."""
    m, n_items, max_len = cfg["model"], cfg["num_items"], cfg["data"]["max_seq_len"]
    d, ffn = m["embed_dim"], m["hidden_size"]
    w = plain.Draws(seed)
    w.normal("item_embedding.weight", n_items, d)[0].zero_()
    w.normal("position_emb.weight", max_len, d)
    for i in range(m["layer_num"]):
        w.encoder_layer(f"encoder.layers.{i}", d, ffn)
    return w.params


def encode(p, seq: torch.Tensor, cfg: dict, training: bool) -> torch.Tensor:
    """[B, L] item ids -> [B, L, D] states; dropout in training."""
    m = cfg["model"]
    drop = m["dropout_rate"]
    pos = p["position_emb.weight"][: seq.shape[1]]
    x = F.embedding(seq, p["item_embedding.weight"]) + pos[None]
    x = F.dropout(x, drop, training)
    for i in range(m["layer_num"]):
        x = plain.encoder_layer(p, f"encoder.layers.{i}", x, seq == 0, True, m["head_num"], drop,
                                training, m["layer_norm_eps"])
    return x


def epoch_batches(rows: Dict[str, np.ndarray], batch_size: int, epoch: int) -> Iterator[dict]:
    """The batches of an epoch as the port's loader makes them: a
    ``default_rng(epoch)`` permutation, the last batch filled with row 0 and
    flagged invalid."""
    n = len(rows["seqlen"])
    order = np.random.default_rng(epoch).permutation(n)
    for b in range(-(-n // batch_size)):
        idx = order[b * batch_size:(b + 1) * batch_size]
        valid = np.arange(batch_size) < len(idx)
        idx = np.concatenate([idx, np.zeros(batch_size - len(idx), idx.dtype)])
        yield {k: rows[k][idx] for k in ("in_item_id", "item_id", "seqlen")} | {"valid": valid}


def on_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device).long() if v.dtype != bool
            else torch.from_numpy(v).to(device) for k, v in batch.items()}


class Run:
    """A training run of the reference: epochs from the seed, or from a
    state it is given (:meth:`load`), with what the comparison reads kept
    as it goes."""

    def __init__(self, cfg: dict, seed: int, device, tf32: bool = False,
                 half_batch: bool = False) -> None:
        self.cfg, self.device, self.tf32, self.half_batch = cfg, device, tf32, half_batch
        self.init = init_params(cfg, seed)
        self.params = plain.on(self.init, device, grad=True)
        t = cfg["train"]
        self.opt = torch.optim.Adam(plain.leaves(self.params), lr=t["learning_rate"])
        self.neg_gen = torch.Generator(device=device).manual_seed(seed + 1)
        torch.manual_seed(seed + 1)
        self.losses: List[float] = []
        self.moment1 = self.after3 = self.after_epoch = None

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        b, l = batch["in_item_id"].shape
        keep = None
        if self.half_batch:  # the fault: the second half of the rows left out
            keep = torch.arange(b, device=self.device) < b // 2
        self.opt.zero_grad(set_to_none=True)
        with plain.precision(self.tf32):
            x = encode(self.params, batch["in_item_id"], self.cfg, training=True)
            # the negatives come after the forward, from their own generator
            neg = torch.randint(1, self.cfg["num_items"], (b, l, 1), generator=self.neg_gen,
                                device=self.device)
            loss = bce_loss(self.params, x, batch, neg, keep)
            loss.backward()
        self.opt.step()
        return loss.detach()

    def epoch(self, rows: Dict[str, np.ndarray], epoch: int) -> float:
        """One epoch; returns the mean loss as the port's trainer takes it
        (an f32 sum on the device over the steps, then divided). Epoch 0
        keeps its first three losses, its first moment, the weights after
        three steps and after the epoch."""
        total = torch.zeros((), device=self.device)
        steps = 0
        first = epoch == 0
        for batch in epoch_batches(rows, self.cfg["train"]["batch_size"], epoch):
            loss = self.step(on_device(batch, self.device))
            total += loss
            steps += 1
            if first and steps <= 3:
                self.losses.append(float(loss))
            if first and steps == 1:
                self.moment1 = {k: self.opt.state[p]["exp_avg"].detach().clone()
                                for k, p in self.params.items()}
            if first and steps == 3:
                self.after3 = {k: p.detach().clone() for k, p in self.params.items()}
        mean = float(total) / steps
        if first:
            self.losses.append(mean)
            self.after_epoch = {k: p.detach().clone() for k, p in self.params.items()}
        return mean

    def load(self, params: Dict[str, torch.Tensor], adam: Dict[str, dict]) -> None:
        """Take ``params`` and Adam's state (``exp_avg``, ``exp_avg_sq``,
        ``step`` by parameter name; none where no step has touched it) as the
        weights and moments to go on from; the generators stay where they
        are."""
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(params[k])
                st = adam[k]
                self.opt.state.pop(p, None)
                if st:
                    self.opt.state[p] = {"step": torch.tensor(float(st["step"])),
                                         "exp_avg": st["exp_avg"].to(p).clone(),
                                         "exp_avg_sq": st["exp_avg_sq"].to(p).clone()}


def bce_loss(p, x: torch.Tensor, batch: Dict[str, torch.Tensor], neg: torch.Tensor,
             keep: torch.Tensor = None) -> torch.Tensor:
    """Per-position BCE of the states ``x`` over the real targets of the
    valid rows (and of the ``keep`` rows if given): -Σ log σ(pos) +
    Σ softplus(neg), over their count."""
    real = torch.arange(x.shape[1], device=x.device)[None, :] < batch["seqlen"][:, None]
    query = torch.where(real[..., None], x, 0.0)
    table = p["item_embedding.weight"]
    pos = (query * F.embedding(batch["item_id"], table)).sum(-1)
    neg_s = (query[:, :, None, :] * F.embedding(neg, table)).sum(-1)
    mask = (batch["item_id"] != 0) & batch["valid"][:, None]
    if keep is not None:
        mask = mask & keep[:, None]
    mask_f = mask.float()
    pos_loss = F.logsigmoid(pos) * mask_f
    neg_loss = F.softplus(neg_s).mean(dim=-1) * mask_f
    return (-pos_loss.sum() + neg_loss.sum()) / mask_f.sum().clamp_min(1.0)


@torch.no_grad()
def serve_scores(p, seq: torch.Tensor, seqlen: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[B, N] eval-mode scores of the whole catalog from the last real
    position, PAD and the seen items of ``seq`` at -1e30."""
    x = encode(p, seq, cfg, training=False)
    last = x[torch.arange(x.shape[0], device=x.device), (seqlen - 1).clamp(0, x.shape[1] - 1)]
    table = p["item_embedding.weight"][: cfg["num_items"]]
    scores = torch.matmul(last, table.T)
    scores[:, 0] = plain.NEG
    return scores.scatter(1, seq, plain.NEG)
