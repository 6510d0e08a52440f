"""Training callbacks: early stopping and the per-history-length analyzer.

Port of ``dr4sr_tpu/train/callbacks.py`` (reference ``utils/callbacks.py``,
``EarlyStopping:12``, ``Analyzer:141``). :class:`EarlyStopping` keeps the
best params as a CPU state_dict and writes the best checkpoint (process 0
alone, under a mesh);
:class:`Analyzer` buckets per-user metrics by history length, returns the
summary and renders it as a figure (matplotlib, Agg backend).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from dr4sr_tpu_torch.parallel.mesh import process_index
from dr4sr_tpu_torch.train.checkpoint import save_checkpoint

logger = logging.getLogger("dr4sr_tpu_torch")


class EarlyStopping:
    def __init__(
        self,
        monitor: str,
        dataset_name: str,
        model_name: str,
        save_dir: Optional[str] = "saved",
        patience: int = 10,
        mode: str = "max",
    ) -> None:
        if mode not in ("min", "max"):
            raise ValueError(f"early-stop mode must be 'min' or 'max', got {mode!r}")
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.model_name = model_name
        self.dataset_name = dataset_name
        self.save_dir = save_dir
        self._counter = 0
        self.best_value = np.inf if mode == "min" else -np.inf
        self.best_epoch = 0
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S-%f")
        self._ckpt_rel = os.path.join(model_name, dataset_name, stamp + ".ckpt")

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.save_dir or ".", self._ckpt_rel)

    def __call__(self, params: Mapping[str, torch.Tensor], config, epoch: int,
                 metrics: Dict[str, float]) -> bool:
        """Returns True when training should stop; snapshots the best params."""
        if self.monitor not in metrics:
            raise ValueError(f"monitor {self.monitor} not in metrics {list(metrics)}")
        value = float(metrics[self.monitor])
        # the reference's rule (utils/callbacks.py:98,106): a tie counts as an
        # improvement, resets patience and re-snapshots the checkpoint
        improved = value >= self.best_value if self.mode == "max" else value <= self.best_value
        if improved:
            self.best_value = value
            self.best_epoch = epoch
            self._counter = 0
            self.best_params = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
            logger.info(f"{self.monitor} improved. Best value: {value:.4f}")
            # single-writer rule under a mesh: every rank holds the same
            # replicated params and reduced metrics, so process 0 writes the
            # best checkpoint and the rest keep only the snapshot
            if self.save_dir is not None and process_index() == 0:
                save_checkpoint(self.checkpoint_path, self.best_params, config,
                                self.model_name, epoch, {self.monitor: value})
        else:
            self._counter += 1
        if self._counter >= self.patience:
            logger.info(
                f"Early stopped: {self.monitor} has not improved for {self._counter} epochs "
                f"(best {self.best_value:.4f} @ epoch {self.best_epoch})."
            )
            return True
        return False


class Analyzer:
    """Bucket per-sample metrics by user-history length
    (reference ``Analyzer``, ``utils/callbacks.py:141-202``)."""

    def __init__(self, boundaries: Optional[List[int]] = None) -> None:
        self.boundaries = boundaries or [5, 10, 20, 30, 50]
        self.reset()

    def reset(self) -> None:
        self._lens: List[np.ndarray] = []
        self._metrics: Dict[str, List[np.ndarray]] = {}

    def record_batch(self, hist_len: np.ndarray, metrics: Dict[str, np.ndarray],
                     valid: Optional[np.ndarray] = None) -> None:
        if valid is None:
            valid = np.ones(len(hist_len), bool)
        self._lens.append(np.asarray(hist_len)[valid])
        for k, v in metrics.items():
            self._metrics.setdefault(k, []).append(np.asarray(v)[valid])

    def plot(self, path: str) -> Optional[str]:
        """Bar charts of each metric by history-length bucket, written to
        ``path`` (the reference pushes these to wandb as matplotlib figures
        every 10 epochs); None when there is nothing to plot or matplotlib is
        not installed."""
        summary = self.summary()
        if not summary:
            return None
        try:
            import matplotlib
        except ImportError:
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, len(summary), figsize=(4 * len(summary), 3), squeeze=False)
        for ax, (metric, buckets) in zip(axes[0], summary.items()):
            ax.bar(range(len(buckets)), list(buckets.values()))
            ax.set_xticks(range(len(buckets)))
            ax.set_xticklabels(list(buckets.keys()), rotation=45, fontsize=7)
            ax.set_title(metric, fontsize=9)
        fig.tight_layout()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path

    def summary(self) -> Dict[str, Dict[str, float]]:
        if not self._lens:
            return {}
        buckets = np.digitize(np.concatenate(self._lens), self.boundaries)
        out: Dict[str, Dict[str, float]] = {}
        for k, chunks in self._metrics.items():
            vals = np.concatenate(chunks)
            by_bucket = {}
            for b in range(len(self.boundaries) + 1):
                sel = buckets == b
                if sel.any():
                    lo = 0 if b == 0 else self.boundaries[b - 1]
                    hi = self.boundaries[b] if b < len(self.boundaries) else "inf"
                    by_bucket[f"len[{lo},{hi})"] = float(vals[sel].mean())
            out[k] = by_bucket
        return out
