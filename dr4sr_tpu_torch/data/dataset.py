"""Datasets for sequential recommendation: rows on the host, fixed widths.

Port of the ``general`` half of ``dr4sr_tpu/data/dataset.py``:

* :class:`RowData` — columnar rows as host numpy arrays with fixed
  ``[N, max_seq_len]`` sequences, so batches slice out without ragged work;
* :func:`load_rows` — the native ``.npz`` layout or the reference's ``.pth``
  row lists (``train{suffix}.pth`` rows of ``[user_id, item_seq, target,
  seqlen, label, domain_id(, hist)]``, cf. ``data/dataset.py:79-91``);
* :func:`_load_meta` — ``meta.npz``, or a scan of ``inter.csv`` with the
  ``csv`` module (no pandas);
* :class:`SeqDataset` (``general``), :func:`get_dataset_class` and
  :func:`prepare_datasets`.

The other dataset classes (``pattern``, ``condense``, ``split``,
``selection``, ``mix``) come with the regen slices; asking for one raises.
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
        import torch

        # the reference's row lists are plain Python containers: no pickled code
        rows = torch.load(pth_path, weights_only=True)
        return rows_from_lists(rows, is_train, max_seq_len)
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
        """Post-load transform hook (the regen dataset classes repack rows here)."""
        self.data = self._data

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
                   seed: int = 0):
        from dr4sr_tpu_torch.data.loader import BatchIterator

        if batch_size is None:
            section = "train" if self.phase == "train" else "eval"
            batch_size = int(self.config[section]["batch_size"])
        if shuffle is None:
            shuffle = self.phase == "train"
        return BatchIterator(self.rows(), batch_size, shuffle=shuffle, seed=seed)


_DATASET_CLASSES = {"general": SeqDataset}
_NOT_PORTED = ("pattern", "condense", "split", "selection", "mix")


def get_dataset_class(config: Dict[str, Any]):
    """Dispatch on ``config['data']['dataset_class']``
    (reference ``BaseModel._get_dataset_class``)."""
    key = config["data"].get("dataset_class", "general")
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset_class {key!r} is not ported to dr4sr_tpu_torch yet (it comes with the "
            f"regen slices); use 'general' or the JAX package"
        )
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
