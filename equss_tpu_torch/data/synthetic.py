"""Synthetic batches for tests and smoke runs.

The port's own copy of ``equss_tpu/data/synthetic.py``: batches with the
contract of the reference's UnSegDataset (``img``, ``aug_img``,
``img_pos`` -- the kNN positive -- and ``label``) from a seeded numpy
generator, so the trainer runs without the COCO / Cityscapes corpora.
The same seed gives the same batches as the JAX package's copy.
Blockwise class regions correlated with the image make the probes learn
above chance.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_batches(
    seed: int,
    n_batches: int,
    batch_size: int,
    res: int = 64,
    num_classes: int = 4,
    with_pos: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """``batch_size`` is the GLOBAL batch; with process_count > 1 every
    process generates the identical global stream (same seed) and yields
    only its contiguous row slice — the multi-host data contract of
    ``mesh.shard_batch`` (DistributedSampler analogue, build.py:183-198)."""
    if batch_size % process_count:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{process_count} processes")
    lo = process_index * (batch_size // process_count)
    hi = lo + batch_size // process_count
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        # blockwise "segments": class id per 8x8 cell, image = class-coded
        # color + noise, so features correlate with labels
        grid = rng.randint(0, num_classes, (batch_size, res // 8, res // 8))
        label = np.repeat(np.repeat(grid, 8, axis=1), 8, axis=2)
        colors = np.linspace(-1.0, 1.0, num_classes)
        img = colors[label][..., None].repeat(3, axis=-1)
        img = img + 0.1 * rng.randn(batch_size, res, res, 3)
        batch = {
            "img": img.astype(np.float32),
            "label": label.astype(np.int32),
        }
        if with_pos:
            pos = img + 0.05 * rng.randn(*img.shape)
            batch["img_pos"] = pos.astype(np.float32)
            batch["aug_img"] = (img + 0.05 * rng.randn(*img.shape)).astype(np.float32)
        if process_count > 1:
            batch = {k: v[lo:hi] for k, v in batch.items()}
        yield batch
