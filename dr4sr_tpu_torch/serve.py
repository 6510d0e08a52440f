"""Serving: batched top-k recommendation on the card.

Port of ``dr4sr_tpu/serve.py::Recommender``: pad the histories into fixed
batches, encode them, score the whole catalog, mask PAD/seen items, top-k.

    rec = RecModel(config, SASRec.build(config, num_items), num_items, 0)
    server = Recommender(rec, rec.module.state_dict())          # on "cuda"
    items, scores = server.recommend([[12, 880, 43], [7, 7, 301]], k=10)

``params`` is a state_dict for ``rec.module`` (``convert.py`` makes one from
a JAX param tree). Reading the JAX flax-msgpack checkpoint
(``from_checkpoint``) comes with the trainer slice.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dr4sr_tpu_torch.models.base import RecModel


class Recommender:
    def __init__(
        self,
        rec: RecModel,
        params: Mapping[str, torch.Tensor],
        item_keep_mask: Optional[np.ndarray] = None,
        batch_size: int = 256,
        device="cuda",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but CUDA is not available")
        module = copy.deepcopy(rec.module)  # the caller's module stays where it is
        module.load_state_dict(params)
        module.to(self.device).eval()
        self.rec = dataclasses.replace(rec, module=module)
        self.max_seq_len = rec.max_seq_len
        self.batch_size = batch_size
        keep = (
            np.ones(rec.num_items, bool)
            if item_keep_mask is None
            else np.array(item_keep_mask, bool)  # copy: never mutate caller's mask
        )
        keep[0] = False
        self.keep_mask = torch.from_numpy(keep).to(self.device)

    @torch.inference_mode()
    def recommend(
        self, histories: Sequence[Sequence[int]], k: int = 10,
        exclude_seen: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (items [N, k'] int64, scores [N, k'] float32) for each
        history, k' = min(k, num_items). (The JAX version sizes them by k and
        fails when k exceeds the catalog.)"""
        k = min(k, self.rec.num_items)
        n = len(histories)
        L = self.max_seq_len
        b = self.batch_size
        out_items = np.zeros((n, k), np.int64)
        out_scores = np.zeros((n, k), np.float32)
        for start in range(0, n, b):
            chunk = histories[start : start + b]
            seq = np.zeros((b, L), np.int64)
            seqlen = np.ones(b, np.int64)
            for i, h in enumerate(chunk):
                h = list(h)[-L:]
                seq[i, : len(h)] = h
                seqlen[i] = max(len(h), 1)
            seq_t = torch.from_numpy(seq).to(self.device)
            batch = {
                "in_item_id": seq_t,
                "seqlen": torch.from_numpy(seqlen).to(self.device),
                "user_hist": seq_t if exclude_seen
                else torch.zeros((b, 1), dtype=torch.int64, device=self.device),
            }
            scores, items = self.rec.topk(batch, k, item_keep_mask=self.keep_mask)
            m = len(chunk)
            out_items[start : start + m] = items[:m].cpu().numpy()
            out_scores[start : start + m] = scores[:m].cpu().numpy()
        return out_items, out_scores
