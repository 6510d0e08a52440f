"""Fixed-shape host-side batch iteration.

Port of ``dr4sr_tpu/data/loader.py``: the same ``np.random.default_rng(seed)``
permutation, so the batches equal the JAX loader's bit for bit. The final
partial batch is padded up to ``batch_size`` (with row 0 of the order's
indices set to 0) and flagged by the ``valid`` mask, unless ``pad_to_full``
is off; ``drop_last`` leaves it out. Fixed shapes keep one set of kernel
launch shapes per epoch and are what a later CUDA graph needs.

Batches are dicts of numpy arrays with the reference's key schema
(``data/dataset.py:149-164``): ``user_id, in_item_id, item_id, seqlen, label,
domain_id, index (, user_hist)`` plus ``valid``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from dr4sr_tpu_torch.data.dataset import RowData

Batch = Dict[str, np.ndarray]


class BatchIterator:
    def __init__(
        self,
        rows: RowData,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        pad_to_full: bool = True,
        drop_last: bool = False,
    ) -> None:
        self.rows = rows
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad_to_full = pad_to_full
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.rows) // self.batch_size
        return (len(self.rows) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.rows)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs : (b + 1) * bs]
            valid_count = len(idx)
            if self.pad_to_full and valid_count < bs:
                idx = np.concatenate([idx, np.zeros(bs - valid_count, dtype=idx.dtype)])
            yield self._make_batch(idx, valid_count)

    def _make_batch(self, idx: np.ndarray, valid_count: int) -> Batch:
        rows = self.rows
        batch: Batch = {
            "user_id": rows.user_id[idx],
            "in_item_id": rows.in_item_id[idx],
            "item_id": rows.item_id[idx],
            "seqlen": rows.seqlen[idx],
            "label": rows.label[idx],
            "domain_id": rows.domain_id[idx],
            "index": idx.astype(np.int32),
            "valid": np.arange(len(idx)) < valid_count,
        }
        if rows.user_hist is not None:
            batch["user_hist"] = rows.user_hist[idx]
        return batch

    def sample_batch(self, batch_size: Optional[int] = None) -> Batch:
        """One batch of rows drawn with replacement from the iterator's own
        generator (the bilevel outer loop's val-proxy and train batches, and
        its weight-statistics probe), padded and flagged as ``__iter__``
        pads a last batch."""
        bs = batch_size or self.batch_size
        n = len(self.rows)
        idx = self._rng.integers(0, n, size=min(bs, n))
        valid_count = len(idx)
        if self.pad_to_full and valid_count < bs:
            idx = np.concatenate([idx, np.zeros(bs - valid_count, dtype=idx.dtype)])
        return self._make_batch(idx, valid_count)
