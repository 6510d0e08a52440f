"""Datasets for sequential recommendation: rows on the host, fixed widths.

Port of the ``general`` half of ``dr4sr_tpu/data/dataset.py``:

* :class:`RowData` — columnar rows as host numpy arrays with fixed
  ``[N, max_seq_len]`` sequences, so batches slice out without ragged work;
* :func:`load_rows` — the native ``.npz`` layout or the reference's ``.pth``
  row lists (``train{suffix}.pth`` rows of ``[user_id, item_seq, target,
  seqlen, label, domain_id(, hist)]``, cf. ``data/dataset.py:79-91``);
* :func:`_load_meta` — ``meta.npz``, or a scan of ``inter.csv`` with the
  ``csv`` module (no pandas);
* :class:`SeqDataset` (``general``) and the ablation classes
  :class:`PatternDataset` (``pattern``), :class:`CondenseDataset`
  (``condense``), :class:`SplitDataset` (``split``),
  :class:`SelectionDataset` (``selection``) and :class:`MixDataset`
  (``mix``), whose train rows equal the JAX package's element for element;
  :func:`get_dataset_class` and :func:`prepare_datasets`.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# Default dataset root, relative to the CWD like the reference ('dataset/').
DATASET_ROOT = os.environ.get("DR4SR_DATASET_ROOT", "dataset")


@dataclasses.dataclass
class RowData:
    """A columnar batch-of-rows with fixed-width sequences.

    ``item_id``/``label`` are ``[N, L]`` for training rows (per-position
    targets) and ``[N]`` for eval rows (single target).
    """

    user_id: np.ndarray  # [N] int32
    in_item_id: np.ndarray  # [N, L] int32
    item_id: np.ndarray  # [N, L] or [N] int32
    seqlen: np.ndarray  # [N] int32
    label: np.ndarray  # [N, L] or [N] float32
    domain_id: np.ndarray  # [N] int32 (one domain per row)
    user_hist: Optional[np.ndarray] = None  # [N, L] int32 (eval only)

    def __len__(self) -> int:
        return int(self.user_id.shape[0])

    @property
    def max_seq_len(self) -> int:
        return int(self.in_item_id.shape[1])

    def select(self, index: np.ndarray) -> "RowData":
        return RowData(
            user_id=self.user_id[index],
            in_item_id=self.in_item_id[index],
            item_id=self.item_id[index],
            seqlen=self.seqlen[index],
            label=self.label[index],
            domain_id=self.domain_id[index],
            user_hist=None if self.user_hist is None else self.user_hist[index],
        )

    @staticmethod
    def concat(parts: Sequence["RowData"]) -> "RowData":
        hist = None
        if all(p.user_hist is not None for p in parts):
            hist = np.concatenate([p.user_hist for p in parts])
        return RowData(
            user_id=np.concatenate([p.user_id for p in parts]),
            in_item_id=np.concatenate([p.in_item_id for p in parts]),
            item_id=np.concatenate([p.item_id for p in parts]),
            seqlen=np.concatenate([p.seqlen for p in parts]),
            label=np.concatenate([p.label for p in parts]),
            domain_id=np.concatenate([p.domain_id for p in parts]),
            user_hist=hist,
        )

    def save_npz(self, path: str) -> None:
        arrays = {k: v for k, v in dataclasses.asdict(self).items() if v is not None}
        np.savez_compressed(path, **arrays)


def rows_from_lists(rows: List[list], is_train: bool, max_seq_len: int) -> RowData:
    """Convert reference-style row lists into :class:`RowData`.

    Train rows: ``[user_id, seq(list[L]), target(list[L]), seqlen,
    label(list[L]), domain_id(list[L])]``; eval rows carry a scalar target and
    label and (implicitly) ``user_hist == seq`` (``data/dataset.py:86-89``).
    """
    n = len(rows)
    user_id = np.fromiter((r[0] for r in rows), np.int32, count=n)
    seqlen = np.fromiter((min(int(r[3]), max_seq_len) for r in rows), np.int32, count=n)
    domain = np.fromiter(
        ((r[5][0] if isinstance(r[5], (list, tuple, np.ndarray)) else int(r[5])) for r in rows),
        np.int32,
        count=n,
    )

    def pack(col, dtype):
        """Right-pad ragged per-row lists into [n, max_seq_len] with one flat scatter."""
        lens = np.fromiter((min(len(r[col]), max_seq_len) for r in rows), np.int64, count=n)
        total = int(lens.sum())
        flat = np.fromiter(
            itertools.chain.from_iterable(itertools.islice(r[col], max_seq_len) for r in rows),
            dtype,
            count=total,
        )
        starts = np.cumsum(lens) - lens
        col_idx = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
        out = np.zeros((n, max_seq_len), dtype)
        out[np.repeat(np.arange(n, dtype=np.int64), lens), col_idx] = flat
        return out

    in_item = pack(1, np.int32)
    if is_train:
        item = pack(2, np.int32)
        label = pack(4, np.float32)
    else:
        item = np.fromiter((int(r[2]) for r in rows), np.int32, count=n)
        label = np.fromiter((float(r[4]) for r in rows), np.float32, count=n)
    hist = in_item.copy() if not is_train else None
    return RowData(user_id, in_item, item, seqlen, label, domain, hist)


def load_rows(path_no_ext: str, is_train: bool, max_seq_len: int) -> RowData:
    """Load rows from ``<path>.npz`` (native) or ``<path>.pth`` (reference)."""
    npz_path = path_no_ext + ".npz"
    pth_path = path_no_ext + ".pth"
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            data = {k: z[k] for k in z.files}
        return RowData(
            user_id=data["user_id"].astype(np.int32),
            in_item_id=data["in_item_id"].astype(np.int32),
            item_id=data["item_id"].astype(np.int32),
            seqlen=data["seqlen"].astype(np.int32),
            label=data["label"].astype(np.float32),
            domain_id=data["domain_id"].astype(np.int32),
            user_hist=data.get("user_hist"),
        )
    if os.path.exists(pth_path):
        from dr4sr_tpu_torch.serialization import load_with_numpy

        # the reference's row lists: Python containers, maybe numpy values
        return rows_from_lists(load_with_numpy(pth_path), is_train, max_seq_len)
    raise FileNotFoundError(f"no dataset file at {path_no_ext}{{.npz,.pth}}")


def _read_inter_csv(path: str):
    """(user ids, item ids) of an ``inter.csv`` with a header naming
    ``user_id`` and ``item_id`` columns."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        users, items = [], []
        for row in reader:
            users.append(int(float(row["user_id"])))
            items.append(int(float(row["item_id"])))
    return np.asarray(users, np.int64), np.asarray(items, np.int64)


def _load_meta(root: str, name: str, domains: Sequence[str]) -> Dict[str, Any]:
    """Id-space metadata: num_users/num_items + per-domain id lists.

    Prefers a precomputed ``meta.npz`` per domain; falls back to scanning
    ``inter.csv`` like the reference (``data/dataset.py:56-65``).
    """
    num_users, num_items = 0, 0
    domain_items: Dict[str, np.ndarray] = {}
    domain_users: Dict[str, np.ndarray] = {}
    for dom in domains:
        dom_dir = os.path.join(root, name, dom)
        meta_path = os.path.join(dom_dir, "meta.npz")
        if os.path.exists(meta_path):
            with np.load(meta_path) as z:
                num_users = max(num_users, int(z["num_users"]))
                num_items = max(num_items, int(z["num_items"]))
                domain_items[dom] = z["domain_items"].astype(np.int64)
                domain_users[dom] = z["domain_users"].astype(np.int64)
        else:
            users, items = _read_inter_csv(os.path.join(dom_dir, "inter.csv"))
            num_users = max(num_users, int(users.max()) + 1)
            num_items = max(num_items, int(items.max()) + 1)
            domain_items[dom] = np.unique(items)
            domain_users[dom] = np.unique(users)
    return {
        "num_users": num_users,
        "num_items": num_items,
        "domain_items": domain_items,
        "domain_users": domain_users,
    }


class SeqDataset:
    """The ``general`` dataset: one row-store per phase, domains concatenated
    for training and kept separate for eval (reference ``SeparateDataset``)."""

    def __init__(self, config: Dict[str, Any], phase: str = "train", root: Optional[str] = None):
        self.config = config
        self.phase = phase
        self.name = config["data"]["dataset"]
        self.root = root or DATASET_ROOT
        self.domain_name_list: List[str] = list(config["data"]["domain_name_list"])
        self.max_seq_len = int(config["data"]["max_seq_len"])
        self.eval_domain = self.domain_name_list[0]

        meta = _load_meta(self.root, self.name, self.domain_name_list)
        self._num_users = meta["num_users"]
        self._num_items = meta["num_items"]
        self.domain_item_mapping = meta["domain_items"]
        self.domain_user_mapping = meta["domain_users"]
        self._load()

    def _phase_path(self, domain: str) -> str:
        suffix = self.config["data"].get("train_file", "") if self.phase == "train" else ""
        return os.path.join(self.root, self.name, domain, self.phase + suffix)

    def _load(self) -> None:
        parts = [
            load_rows(self._phase_path(dom), self.phase == "train", self.max_seq_len)
            for dom in self.domain_name_list
        ]
        if self.phase == "train":
            self._data = RowData.concat(parts)
        else:
            self._data = {d: p for d, p in zip(self.domain_name_list, parts)}

    def build(self) -> None:
        """Post-load transform hook: the train rows go through
        :meth:`_transform_train`, which the ablation classes override."""
        if self.phase == "train":
            self.data = self._transform_train(self._data)
        else:
            self.data = self._data

    def _transform_train(self, data: RowData) -> RowData:
        return data

    @property
    def num_users(self) -> int:
        return self._num_users

    @property
    def num_items(self) -> int:
        return self._num_items

    def set_eval_domain(self, domain: str) -> None:
        self.eval_domain = domain

    def rows(self) -> RowData:
        if self.phase == "train":
            return self.data
        return self.data[self.eval_domain]

    def __len__(self) -> int:
        return len(self.rows())

    def domain_item_mask(self, domain: str) -> np.ndarray:
        """Boolean [num_items]: True where the item belongs to ``domain``."""
        mask = np.zeros(self.num_items, bool)
        mask[self.domain_item_mapping[domain]] = True
        return mask

    def get_loader(self, batch_size: Optional[int] = None, shuffle: Optional[bool] = None,
                   seed: int = 0, pad_to_full: bool = True, drop_last: bool = False):
        from dr4sr_tpu_torch.data.loader import BatchIterator

        if batch_size is None:
            section = "train" if self.phase == "train" else "eval"
            batch_size = int(self.config[section]["batch_size"])
        if shuffle is None:
            shuffle = self.phase == "train"
        return BatchIterator(self.rows(), batch_size, shuffle=shuffle, seed=seed,
                             pad_to_full=pad_to_full, drop_last=drop_last)


class PatternDataset(SeqDataset):
    """Parallel original and pattern (regenerated) train rows (reference
    ``PatternDataset``, ``data/dataset.py:166-222``): the pattern view reads
    ``train{train_file}``, the original view ``train``; ``set_mode`` picks
    one of them or both."""

    def _load(self) -> None:
        if self.phase != "train":
            super()._load()
        else:
            suffix = self.config["data"].get("train_file", "")
            self._pattern_data = RowData.concat([
                load_rows(os.path.join(self.root, self.name, dom, "train" + suffix), True,
                          self.max_seq_len)
                for dom in self.domain_name_list
            ])
            self._data = RowData.concat([
                load_rows(os.path.join(self.root, self.name, dom, "train"), True,
                          self.max_seq_len)
                for dom in self.domain_name_list
            ])
        self.mode = "original"

    def set_mode(self, mode: str) -> None:
        if self.phase != "train":
            raise ValueError("set_mode applies to the train phase")
        if mode == "original":
            self.data = self._data
        elif mode == "pattern":
            self.data = self._pattern_data
        elif mode == "all":
            self.data = RowData.concat([self._data, self._pattern_data])
        else:
            raise NotImplementedError(mode)
        self.mode = mode


class CondenseDataset(SeqDataset):
    """Greedy packing: the longest remaining row, then the shortest ones
    while they fit in ``max_seq_len`` (reference
    ``CondenseDataset._condense_sequences``, ``data/dataset.py:300-332``)."""

    def _transform_train(self, data: RowData) -> RowData:
        L = self.max_seq_len
        order = np.argsort(-data.seqlen, kind="stable")
        seqs = data.in_item_id[order]
        tgts = data.item_id[order]
        lens = data.seqlen[order].tolist()
        out_seq, out_tgt, out_len = [], [], []
        lo, hi = 0, len(lens) - 1
        while lo <= hi:
            cur_seq = list(seqs[lo][: lens[lo]])
            cur_tgt = list(tgts[lo][: lens[lo]])
            cur_len = lens[lo]
            while lo != hi and cur_len + lens[hi] <= L:
                cur_seq += list(seqs[hi][: lens[hi]])
                cur_tgt += list(tgts[hi][: lens[hi]])
                cur_len += lens[hi]
                hi -= 1
            out_seq.append(cur_seq + [0] * (L - cur_len))
            out_tgt.append(cur_tgt + [0] * (L - cur_len))
            out_len.append(cur_len)
            lo += 1
        n = len(out_seq)
        seq_arr = np.asarray(out_seq, np.int32).reshape(n, L)
        return RowData(
            user_id=np.zeros(n, np.int32),
            in_item_id=seq_arr,
            item_id=np.asarray(out_tgt, np.int32).reshape(n, L),
            seqlen=np.asarray(out_len, np.int32),
            label=(seq_arr != 0).astype(np.float32),
            domain_id=np.zeros(n, np.int32),
        )


class SplitDataset(SeqDataset):
    """Rows longer than half of ``max_seq_len`` (and at least 10) are cut in
    two at a point drawn from ``np.random.default_rng(seed)`` in [5, n − 5]
    (reference ``SplitDataset``): the kept rows first, then every first
    half, then every second half."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        self._rng = np.random.default_rng(seed)
        super().__init__(*args, **kwargs)

    def _transform_train(self, data: RowData) -> RowData:
        L = self.max_seq_len
        keep, first, cuts = [], [], []
        for i in range(len(data)):
            n = int(data.seqlen[i])
            if n > L // 2 and n >= 10:
                first.append(i)
                cuts.append(int(self._rng.integers(5, n - 5 + 1)))
            else:
                keep.append(i)
        parts = [data.select(np.asarray(keep, np.int64))] if keep else []
        if first:
            idx = np.asarray(first, np.int64)
            for which in (0, 1):
                sel = data.select(idx)
                for j, (i, cut) in enumerate(zip(first, cuts)):
                    n = int(data.seqlen[i])
                    lo, hi = (0, cut) if which == 0 else (cut, n)
                    sel.in_item_id[j] = np.pad(data.in_item_id[i][lo:hi], (0, L - (hi - lo)))
                    sel.item_id[j] = np.pad(data.item_id[i][lo:hi], (0, L - (hi - lo)))
                    sel.seqlen[j] = hi - lo
                    sel.label[j] = np.arange(L) < hi - lo
                parts.append(sel)
        return RowData.concat(parts)


class SelectionDataset(SeqDataset):
    """A random half of the train rows: the first ``n // 2`` of a
    ``np.random.default_rng(seed)`` permutation (reference
    ``SelectionDataset``)."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        self._rng = np.random.default_rng(seed)
        super().__init__(*args, **kwargs)

    def _transform_train(self, data: RowData) -> RowData:
        n = len(data)
        return data.select(self._rng.permutation(n)[: n // 2])


class MixDataset(SeqDataset):
    """One mixed train file for every domain, ``<root>/<name>/train.*``
    (reference ``MixDataset``, ``data/dataset.py:224-265``); eval rows stay
    per domain."""

    def _load(self) -> None:
        if self.phase == "train":
            self._data = load_rows(os.path.join(self.root, self.name, "train"), True,
                                   self.max_seq_len)
        else:
            super()._load()


_DATASET_CLASSES = {
    "general": SeqDataset,
    "pattern": PatternDataset,
    "condense": CondenseDataset,
    "split": SplitDataset,
    "selection": SelectionDataset,
    "mix": MixDataset,
}


def get_dataset_class(config: Dict[str, Any]):
    """Dispatch on ``config['data']['dataset_class']``
    (reference ``BaseModel._get_dataset_class``)."""
    key = config["data"].get("dataset_class", "general")
    if key not in _DATASET_CLASSES:
        raise NotImplementedError(f"dataset_class {key!r}")
    return _DATASET_CLASSES[key]


def prepare_datasets(config: Dict[str, Any], root: Optional[str] = None):
    """Train/val/test dataset triple (reference ``prepare_datasets``)."""
    cls = get_dataset_class(config)
    out = []
    for phase in ("train", "val", "test"):
        ds = cls(config, phase=phase, root=root)
        ds.build()
        out.append(ds)
    return tuple(out)
