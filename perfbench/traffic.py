"""The one traffic generator: it reads a mix's parameters (a file under
``traffic/``) and makes that mix's inputs from the seed.

Images are uint8 RGB with some structure, so that the probes see
regions and not only noise: a low-resolution grid of random colours,
upsampled bilinearly, plus per-pixel noise.  Labels share the grid: one
class per cell, some cells ignored (-1).  Everything is drawn on the
device from one ``torch.Generator`` and copied to pageable host memory
once, as a data loader's batches arrive.  STEGO's draws (``stego_coords1``,
``stego_coords2``, ``stego_perms``) are made per batch on the host, so
that the program and the reference take the same samples.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed: weights, traffic and
    the trainer draw from streams that do not overlap."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def images(g: torch.Generator, n: int, res: int, grid: int, noise: float,
           device: torch.device) -> torch.Tensor:
    """(n, res, res, 3) uint8 on ``device``."""
    low = torch.rand((n, 3, grid, grid), generator=g, device=device)
    img = F.interpolate(low, size=(res, res), mode="bilinear", align_corners=False)
    img = img + noise * torch.randn(img.shape, generator=g, device=device)
    return (img.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def labels(g: torch.Generator, n: int, res: int, grid: int, classes: int,
           ignore_share: float, device: torch.device) -> torch.Tensor:
    """(n, res, res) int32 on ``device``: one class per grid cell, -1 on
    an ``ignore_share`` of the cells."""
    cells = torch.randint(0, classes, (n, 1, grid, grid), generator=g, device=device)
    drop = torch.rand((n, 1, grid, grid), generator=g, device=device) < ignore_share
    cells = torch.where(drop, torch.full_like(cells, -1), cells)
    up = F.interpolate(cells.float(), size=(res, res), mode="nearest")
    return up[:, 0].to(torch.int32)


def super_perm(rng: np.random.Generator, size: int) -> np.ndarray:
    """A permutation with each fixed point moved on by one (mod size), as
    STEGO draws its negatives."""
    perm = rng.permutation(size)
    ar = np.arange(size)
    return np.where(perm == ar, perm + 1, perm) % size


def stego_draws(rng: np.random.Generator, batch: int, samples: int,
                negatives: int) -> Dict[str, torch.Tensor]:
    coords = [torch.from_numpy(rng.uniform(-1.0, 1.0, (batch, samples, samples, 2))
                               .astype(np.float32)) for _ in range(2)]
    perms = np.stack([super_perm(rng, batch) for _ in range(negatives)]).astype(np.int64)
    return {"stego_coords1": coords[0], "stego_coords2": coords[1],
            "stego_perms": torch.from_numpy(perms)}


def segment_pool(mix: Dict[str, Any], seed: int, device: torch.device) -> List[torch.Tensor]:
    """``pool`` distinct host batches of ``batch`` images."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic"))
    return [images(g, mix["batch"], mix["res"], mix["grid"], mix["noise"], device).cpu()
            for _ in range(mix["pool"])]


def train_pool(mix: Dict[str, Any], seed: int, classes: int,
               stego: Optional[Dict[str, Any]],
               device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """``pool`` distinct host batches in the input pipeline's form:
    ``img``, ``img_pos`` (the kNN positive), ``label`` and, where the
    configuration has a STEGO loss (``stego``), STEGO's draws."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic"))
    rng = np.random.default_rng(sub_seed(seed, "stego"))
    out = []
    for _ in range(mix["pool"]):
        b, res, grid = mix["batch"], mix["res"], mix["grid"]
        batch = {"img": images(g, b, res, grid, mix["noise"], device).cpu(),
                 "img_pos": images(g, b, res, grid, mix["noise"], device).cpu(),
                 "label": labels(g, b, res, grid, classes, mix["ignore_share"], device).cpu()}
        if stego is not None:
            batch.update(stego_draws(rng, b, stego["feature_samples"], stego["neg_samples"]))
        out.append(batch)
    return out


def order(seed: int, pool: int, count: int) -> List[int]:
    """The pool index of each of ``count`` requests or steps: the pool in
    a seeded order, again in a fresh order each round."""
    rng = np.random.default_rng(sub_seed(seed, "order"))
    out: List[int] = []
    while len(out) < count:
        out.extend(int(i) for i in rng.permutation(pool))
    return out[:count]
