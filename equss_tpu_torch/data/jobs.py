"""Offline data jobs: the five-crop corpus and the kNN-positive cache.

Counterpart of ``equss_tpu/data/jobs.py``:

1. ``materialize_crops`` crops every image of a split into 5 sub-images
   at ``crop_ratio`` and writes ``img/{i}.jpg`` and ``label/{i}.png`` with
   the label + 1 offset that ``CroppedDataset`` reads back.
2. ``precompute_knns`` computes the mean-pooled, L2-normalised backbone
   features of the whole corpus (``extract_pooled_features``: the
   model's ``features``, so the attention kernel on CUDA) and their
   cosine top-k neighbours (``topk_neighbors``: the similarity in
   row chunks with ``torch.matmul`` and ``torch.topk``, so the full
   similarity matrix never exists), and saves ``nns`` in an ``.npz``.
   Both run on the model's device; the pooling and the top-k are plain
   torch ops, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import os
from os.path import join
from typing import Optional

import numpy as np
import torch

from equss_tpu_torch.data.datasets import build_base_dataset
from equss_tpu_torch.data.transforms import five_crop_np, normalize_images, random_crops_np


def materialize_crops(dataset_name: str, data_dir: str, out_dir: Optional[str] = None, *,
                      mode: str = "train", crop_type: str = "five", crop_ratio: float = 0.5,
                      res: int = 0, limit: Optional[int] = None) -> str:
    """Write ``cropped/{ds}_{type}_crop_{ratio}/img|label/{mode}/{i}.jpg|png``
    under ``out_dir`` (default ``data_dir``) from the full-resolution
    images of ``mode``: item i's crops are files 5 i .. 5 i + 4.  Returns
    the corpus directory."""
    from PIL import Image

    out_root = join(out_dir or data_dir, "cropped",
                    f"{dataset_name}_{crop_type}_crop_{crop_ratio}")
    img_dir = join(out_root, "img", mode)
    label_dir = join(out_root, "label", mode)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)
    # the file lists and label remap of the dataset; its resize is not used
    ds = build_base_dataset(dataset_name, mode, data_dir, res=res or 320, crop_type=None,
                            loader_crop_type="none")
    n = len(ds) if limit is None else min(limit, len(ds))
    for item_idx in range(n):
        img = np.asarray(Image.open(ds.image_files[item_idx]).convert("RGB"), np.uint8)
        label = ds.remap_label(np.asarray(Image.open(ds.label_files[item_idx]), np.int32))
        ch = int(img.shape[0] * crop_ratio)
        cw = int(img.shape[1] * crop_ratio)
        if crop_type == "five":
            img_crops, lbl_crops = five_crop_np(img, ch, cw), five_crop_np(label, ch, cw)
        elif crop_type == "random":
            img_crops = random_crops_np(img, ch, cw, item_idx, 5)
            lbl_crops = random_crops_np(label, ch, cw, item_idx, 5)
        else:
            raise ValueError(f"Unknown crop type {crop_type}")
        for crop_num, (ic, lc) in enumerate(zip(img_crops, lbl_crops)):
            i = item_idx * 5 + crop_num
            Image.fromarray(ic).save(join(img_dir, f"{i}.jpg"), "JPEG")
            # label + 1, so that 0 encodes ignore
            Image.fromarray((lc + 1).astype(np.uint8)).save(join(label_dir, f"{i}.png"), "PNG")
    return out_root


def extract_pooled_features(model, data, *, batch_size: int = 32,
                            max_items: Optional[int] = None) -> torch.Tensor:
    """Mean-pooled, L2-normalised dense features (n, C) f32 of every image
    of ``data`` (an ``UnSegData``, in order), computed by ``model`` (any
    registry model: its ``features``) on its device; the first
    ``max_items`` only when given."""
    out = []
    seen = 0
    for batch in data.batches(batch_size, shuffle=False, drop_last=False):
        img = torch.from_numpy(batch["img"]).to(model.device, non_blocking=True)
        with torch.no_grad():
            f = model.features(normalize_images(img)).mean(dim=(1, 2))
            f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp_min(1e-12)
        out.append(f)
        seen += len(batch["img"])
        if max_items is not None and seen >= max_items:
            break
    feats = torch.cat(out)
    return feats[:max_items] if max_items else feats


def topk_neighbors(feats, k: int = 30, chunk: int = 1024) -> np.ndarray:
    """The ``k`` largest cosine similarities of each row of the
    L2-normalised ``feats`` (n, C) among all rows, as (n, k) int32 indices
    in descending order, on ``feats``' device, ``chunk`` query rows at a
    time."""
    feats = torch.as_tensor(feats, dtype=torch.float32)
    outs = []
    for start in range(0, feats.shape[0], chunk):
        sim = torch.matmul(feats[start: start + chunk], feats.T)
        outs.append(torch.topk(sim, k, dim=-1).indices.to(torch.int32).cpu())
    return torch.cat(outs).numpy()


def precompute_knns(model, data, out_path: str, *, k: int = 30, batch_size: int = 32,
                    max_items: Optional[int] = None) -> str:
    """The whole job: features -> top-k -> ``np.savez_compressed(out_path,
    nns=...)``; returns ``out_path`` (its name is the caller's)."""
    feats = extract_pooled_features(model, data, batch_size=batch_size, max_items=max_items)
    nns = topk_neighbors(feats, min(k, feats.shape[0]))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, nns=nns)
    return out_path
