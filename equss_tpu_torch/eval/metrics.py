"""Streaming confusion matrix and Hungarian-matched mIoU / Accuracy.

Counterpart of ``equss_tpu/eval/metrics.py``: ``confusion_update`` is
plain tensor code on the tensors' device; ``UnSegMetrics`` accumulates
on the host and matches clusters to classes with
``scipy.optimize.linear_sum_assignment`` at ``compute()`` time (a 27 x 27
problem), including the extra-classes over-clustering path.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def confusion_update(preds: torch.Tensor, label: torch.Tensor, num_classes: int,
                     extra_classes: int = 0) -> torch.Tensor:
    """One batch's confusion matrix, (num_classes + extra_classes,
    num_classes) int64 on the tensors' device: rows are predictions,
    columns labels.  Pixels whose label or prediction lies outside [0,
    num_classes) are left out.

    ``index_add_`` of ones at ``label * n_pred + pred`` counts in int64,
    so the counts are exact at any pixel count (the JAX function's one-hot
    product in f32 is exact only below 2^24 per call and guards that; no
    guard is needed here).  Masked pixels go to one extra bin that is
    dropped.  Nothing is read back to the host (``torch.bincount`` would
    read its input's maximum)."""
    preds = preds.reshape(-1).long()
    label = label.reshape(-1).long()
    n_pred = num_classes + extra_classes
    mask = (label >= 0) & (label < num_classes) & (preds >= 0) & (preds < num_classes)
    bins = num_classes * n_pred
    idx = torch.where(mask, label * n_pred + preds, bins)
    counts = torch.zeros(bins + 1, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))[:bins]
    return counts.reshape(num_classes, n_pred).T


class UnSegMetrics:
    """Host-side accumulator.  ``update`` takes tensors (any device) or
    numpy arrays."""

    def __init__(self, num_classes: int, extra_classes: int = 0,
                 compute_hungarian: bool = True) -> None:
        if (not compute_hungarian) and extra_classes != 0:
            raise ValueError("extra_classes requires Hungarian matching")
        self.num_classes = num_classes
        self.extra_classes = extra_classes
        self.compute_hungarian = compute_hungarian
        self.reset()

    def reset(self) -> None:
        n = self.num_classes
        self.confusion = np.zeros((n + self.extra_classes, n), np.int64)
        self.assignments: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.histogram: Optional[np.ndarray] = None

    def update(self, preds, label) -> None:
        self.update_confusion(confusion_update(
            torch.as_tensor(preds), torch.as_tensor(label),
            self.num_classes, self.extra_classes))

    def update_confusion(self, conf) -> None:
        """Add a precomputed confusion matrix (tensor or numpy)."""
        if torch.is_tensor(conf):
            conf = conf.cpu().numpy()
        self.confusion += np.asarray(conf)

    def compute(self) -> Dict[str, float]:
        """``iou`` (mean over classes) and ``accuracy``, in percent, after
        Hungarian matching of clusters to classes (identity without
        ``compute_hungarian``); sets ``assignments`` and ``histogram``."""
        n = self.num_classes
        conf = self.confusion
        if self.compute_hungarian:
            self.assignments = linear_sum_assignment(conf, maximize=True)
            if self.extra_classes == 0:
                histogram = conf[np.argsort(self.assignments[1]), :]
            else:
                # over-clustering: the unmatched clusters form one more row
                assignments_t = linear_sum_assignment(conf.T, maximize=True)
                histogram = conf[assignments_t[1], :]
                missing = sorted(
                    set(range(n + self.extra_classes)) - set(self.assignments[0]))
                new_row = conf[missing, :].sum(0, keepdims=True)
                histogram = np.concatenate([histogram, new_row], axis=0)
                new_col = np.zeros((n + 1, 1), histogram.dtype)
                histogram = np.concatenate([histogram, new_col], axis=1)
        else:
            self.assignments = (np.arange(n), np.arange(n))
            histogram = conf
        self.histogram = histogram

        tp = np.diag(histogram).astype(np.float64)
        fp = histogram.sum(0) - tp[: histogram.shape[1]]
        fn = histogram.sum(1) - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = tp / (tp + fp[: len(tp)] + fn)
        miou = np.nanmean(np.where(np.isfinite(iou), iou, np.nan))
        accuracy = tp.sum() / max(histogram.sum(), 1)
        return {"iou": 100.0 * float(miou), "accuracy": 100.0 * float(accuracy)}

    def map_clusters(self, clusters):
        """Cluster id -> class id (-1 for an unmatched extra cluster), for
        visualisation; after ``compute()``."""
        if self.assignments is None:
            raise RuntimeError("call compute() first")
        if self.extra_classes == 0:
            return np.asarray(self.assignments[1])[np.asarray(clusters)]
        missing = sorted(set(range(self.num_classes + self.extra_classes))
                         - set(self.assignments[0]))
        cluster_to_class = np.asarray(self.assignments[1])
        for m in missing:
            if m >= cluster_to_class.shape[0]:
                cluster_to_class = np.append(cluster_to_class, -1)
            else:
                cluster_to_class = np.insert(cluster_to_class, m + 1, -1)
        return cluster_to_class[np.asarray(clusters)]
