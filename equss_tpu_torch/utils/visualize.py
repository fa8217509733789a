"""PNG dumps of predictions.

Counterpart of ``equss_tpu/utils/visualize.py`` (the reference's
visualize_utils.py): ``visualization`` writes each image's linear,
cluster and label maps under ``linear/``, ``cluster/`` and ``label/``
with the dataset's colormap, the cluster ids remapped through the
Hungarian assignment of a computed ``UnSegMetrics``; ``pq_visualization``
writes each subspace's codeword-index map, upsampled by the patch size,
under ``pq_<m>/``.  The maps may be tensors on any device or numpy
arrays; they are copied to the host here, where the PNGs are encoded
(PIL, imported only to write them).  The same arrays give the same PNG
bytes as the JAX package's.
"""
from __future__ import annotations

import os
from os.path import join
from typing import Any, Optional, Sequence

import numpy as np
import torch

from equss_tpu_torch.data.catalog import (create_cityscapes_colormap,
                                          create_pascal_label_colormap, create_pq_colormap)


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _colormap_for(dataset_name: str) -> np.ndarray:
    if dataset_name in ("voc", "pascal", "cocostuff27", "cocostuff15", "cocostuff3",
                        "potsdam"):
        return create_pascal_label_colormap()
    return create_cityscapes_colormap()


def _save_colored(arr: np.ndarray, cmap: np.ndarray, path: str) -> None:
    from PIL import Image

    arr = np.asarray(arr).astype(np.int32)   # labels may arrive int8
    rgb = cmap[np.clip(arr, 0, len(cmap) - 1)].astype(np.uint8)
    rgb[arr < 0] = 0
    Image.fromarray(rgb).save(path)


def visualization(save_dir: str, dataset_name: str, saved_data: dict,
                  metrics_cluster=None, is_label: bool = True) -> None:
    """``<save_dir>/{linear,cluster,label}/<i>.png`` for each image i of
    ``saved_data``'s ``linear_preds`` and ``cluster_preds`` (N, H, W) and,
    with ``is_label``, ``label``; the cluster ids are remapped with
    ``metrics_cluster.map_clusters`` where a computed ``UnSegMetrics`` is
    given."""
    cmap = _colormap_for(dataset_name)
    for sub in ("linear", "cluster") + (("label",) if is_label else ()):
        os.makedirs(join(save_dir, sub), exist_ok=True)
    linear = _host(saved_data["linear_preds"])
    cluster = _host(saved_data["cluster_preds"])
    label = _host(saved_data["label"]) if is_label else None
    for i in range(linear.shape[0]):
        _save_colored(linear[i], cmap, join(save_dir, "linear", f"{i}.png"))
        c = cluster[i] if metrics_cluster is None else metrics_cluster.map_clusters(cluster[i])
        _save_colored(c, cmap, join(save_dir, "cluster", f"{i}.png"))
        if label is not None:
            _save_colored(label[i], cmap, join(save_dir, "label", f"{i}.png"))


def pq_visualization(save_dir: str, indices: Any, subspaces: Optional[Sequence[int]] = None,
                     upsample: int = 8) -> None:
    """``<save_dir>/pq_<m>/<i>.png``: the codeword ids of subspace m of
    image i (indices (N, h, w, M)), modulo the colormap's length and
    upsampled ``upsample`` times in each direction; every subspace unless
    ``subspaces`` names some."""
    cmap = create_pq_colormap()
    indices = _host(indices)
    n, M = indices.shape[0], indices.shape[-1]
    subspaces = list(subspaces) if subspaces is not None else list(range(M))
    for m in subspaces:
        os.makedirs(join(save_dir, f"pq_{m}"), exist_ok=True)
    for i in range(n):
        for m in subspaces:
            idx_map = indices[i, :, :, m] % len(cmap)
            big = np.repeat(np.repeat(idx_map, upsample, 0), upsample, 1)
            _save_colored(big, cmap, join(save_dir, f"pq_{m}", f"{i}.png"))
