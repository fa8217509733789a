"""Frozen-backbone feature cache.

Counterpart of ``equss_tpu/data/feature_cache.py``.  The backbone is
frozen, so its dense features are constants of the dataset:
``precompute_features`` runs it once over a dataset, on the model's
device (the attention kernel in a bf16 backbone), and writes them to an
``.npz``; ``cached_feature_batches`` then serves ``feat`` / ``feat_pos``
batches that ``Trainer.train_step`` takes in place of images, so a step
runs the head, the quantizer and the losses without the backbone.  The
file format and the batch order are the JAX package's, so a cache
written by either package gives the same batches in the other.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from equss_tpu_torch.data.transforms import normalize_images


def precompute_features(model, data, out_path: str, *, batch_size: int = 32,
                        max_items: Optional[int] = None) -> str:
    """``model.features`` of every image of ``data`` (an object with
    ``batches(batch_size, shuffle=False, drop_last=False)`` yielding
    ``img`` (b, H, W, 3) uint8 and ``label``), normalised on the model's
    device, in order, for at most ``max_items`` images -> a compressed
    ``.npz`` at ``out_path`` with ``feats`` (N, gh, gw, C) f32 and
    ``labels``.  ``model.features`` returns f32: a bf16 backbone's
    features are written as their exact f32 upcast (numpy has no bf16).
    Returns ``out_path``."""
    device = model.device
    feats, labels = [], []
    seen = 0
    with torch.no_grad():
        for batch in data.batches(batch_size, shuffle=False, drop_last=False):
            img = torch.as_tensor(np.asarray(batch["img"])).to(device)
            feats.append(model.features(normalize_images(img)).cpu().numpy())
            labels.append(np.asarray(batch["label"]))
            seen += len(batch["img"])
            if max_items is not None and seen >= max_items:
                break
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, feats=np.concatenate(feats)[:max_items],
                        labels=np.concatenate(labels)[:max_items])
    return out_path


def cached_feature_batches(cache_path: str, nns: Optional[np.ndarray], batch_size: int, *,
                           num_neighbors: int = 7, seed: int = 0,
                           shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch over a feature cache: ``feat``, ``label`` and
    ``feat_pos``, the features of a kNN positive drawn from ``nns`` (N,
    k) rows' neighbours 1..num_neighbors (clipped to the table), or the
    features themselves without ``nns``.  Shuffled by
    ``np.random.RandomState(seed)`` dropping the last partial batch, or in
    order keeping it; the JAX package's order and draws."""
    blob = np.load(cache_path)
    feats, labels = blob["feats"], blob["labels"]
    n = len(feats)
    rng = np.random.RandomState(seed)
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    stop = n - (n % batch_size) if shuffle else n
    for start in range(0, stop, batch_size):
        idx = order[start: start + batch_size]
        batch = {"feat": feats[idx], "label": labels[idx]}
        if nns is not None:
            k = rng.randint(1, num_neighbors + 1, size=len(idx))
            batch["feat_pos"] = feats[nns[idx, np.minimum(k, nns.shape[1] - 1)]]
        else:
            batch["feat_pos"] = feats[idx]
        yield batch
