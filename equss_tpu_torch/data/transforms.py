"""Image transforms: host-side decode, resize and crop; device-side
normalisation.

Counterpart of ``equss_tpu/data/transforms.py``:

* host (PIL and numpy): ``resize_shorter_np`` (NEAREST, shorter side or
  exact size), ``center_crop_np``, ``random_crop_np``, ``load_image``,
  ``prepare_image``, ``load_label``, ``five_crop_np`` and
  ``random_crops_np``, which turn files into fixed-shape uint8 arrays,
  pixel for pixel as the JAX package does;
* device: ``normalize_images`` (ToTensor + ImageNet Normalize), so a
  request can be raw uint8 or [0, 1] float RGB, and its inverse
  ``unnormalize_images``, which gives the dense CRF its colours back.

PIL is imported where a file is decoded, so the module imports without
it.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------- host side

def resize_shorter_np(img, res, nearest: bool = True):
    """torchvision ``T.Resize(res, NEAREST)`` on a PIL image: an int
    ``res`` scales the shorter side to it; an ``(h, w)`` resizes
    exactly."""
    from PIL import Image

    if isinstance(res, (tuple, list)):
        out_h, out_w = res
    else:
        w, h = img.size
        if w <= h:
            out_w = res
            out_h = max(int(round(res * h / w)), 1)
        else:
            out_h = res
            out_w = max(int(round(res * w / h)), 1)
    resample = Image.NEAREST if nearest else Image.BILINEAR
    return img.resize((out_w, out_h), resample)


def center_crop_np(arr: np.ndarray, size: int) -> np.ndarray:
    """torchvision ``CenterCrop`` on an HW[C] array (zero-padded if
    smaller)."""
    h, w = arr.shape[:2]
    if h < size or w < size:
        pad_h, pad_w = max(size - h, 0), max(size - w, 0)
        pads = [(pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2)]
        if arr.ndim == 3:
            pads.append((0, 0))
        arr = np.pad(arr, pads)
        h, w = arr.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return arr[top: top + size, left: left + size]


def random_crop_np(arr: np.ndarray, size: int, rng: np.random.RandomState) -> np.ndarray:
    """A ``size`` square at a corner drawn from ``rng`` (top, then left)."""
    h, w = arr.shape[:2]
    top = rng.randint(0, max(h - size, 0) + 1)
    left = rng.randint(0, max(w - size, 0) + 1)
    return arr[top: top + size, left: left + size]


def _crop(arr: np.ndarray, res: int, crop_type: str,
          rng: Optional[np.random.RandomState],
          crop_coords: Optional[Tuple[int, int]]) -> np.ndarray:
    if crop_type == "center":
        return center_crop_np(arr, res)
    if crop_type == "random":
        if crop_coords is not None:
            top, left = crop_coords
            return arr[top: top + res, left: left + res]
        return random_crop_np(arr, res, rng or np.random)
    raise ValueError(f"Unknown Cropper {crop_type}")


def load_image(path: str, res: int, crop_type: str = "center",
               rng: Optional[np.random.RandomState] = None,
               crop_coords: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode + NEAREST resize + crop -> (res, res, 3) uint8."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return prepare_image(img, res, crop_type, rng, crop_coords)


def prepare_image(img, res: int, crop_type: str = "center",
                  rng: Optional[np.random.RandomState] = None,
                  crop_coords: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """A PIL RGB image -> (res, res, 3) uint8: ``none`` stretches to
    (res, res); ``center`` and ``random`` resize the shorter side to res
    and crop (``crop_coords`` fixes a random crop's corner)."""
    if crop_type in (None, "none"):
        return np.asarray(resize_shorter_np(img, (res, res)), np.uint8)
    arr = np.asarray(resize_shorter_np(img, res), np.uint8)
    return _crop(arr, res, crop_type, rng, crop_coords)


def load_label(path_or_img, res: int, crop_type: str = "center",
               rng: Optional[np.random.RandomState] = None,
               crop_coords: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode (a path or a PIL image) + NEAREST resize + crop for labels
    -> (res, res) int32 (gray values or palette indices)."""
    from PIL import Image

    img = path_or_img if isinstance(path_or_img, Image.Image) else Image.open(path_or_img)
    if crop_type in (None, "none"):
        return np.asarray(resize_shorter_np(img, (res, res)), np.int32)
    arr = np.asarray(resize_shorter_np(img, res), np.int32)
    return _crop(arr, res, crop_type, rng, crop_coords)


def five_crop_np(arr: np.ndarray, crop_h: int, crop_w: int):
    """torchvision ``five_crop``: top-left, top-right, bottom-left,
    bottom-right, center."""
    h, w = arr.shape[:2]
    tl = arr[:crop_h, :crop_w]
    tr = arr[:crop_h, w - crop_w:]
    bl = arr[h - crop_h:, :crop_w]
    br = arr[h - crop_h:, w - crop_w:]
    center = center_crop_np(arr, crop_h) if crop_h == crop_w else \
        arr[(h - crop_h) // 2:(h - crop_h) // 2 + crop_h,
            (w - crop_w) // 2:(w - crop_w) // 2 + crop_w]
    return [tl, tr, bl, br, center]


def random_crops_np(arr: np.ndarray, crop_h: int, crop_w: int, seed: int, n: int = 5):
    """``n`` crops at corners drawn from ``RandomState(hash((seed, i)))``:
    deterministic per (seed, i) (a tuple of ints hashes the same in every
    process)."""
    h, w = arr.shape[:2]
    out = []
    for i in range(n):
        rs = np.random.RandomState(abs(hash((seed, i))) % (2**31))
        top = rs.randint(0, h - crop_h)
        left = rs.randint(0, w - crop_w)
        out.append(arr[top: top + crop_h, left: left + crop_w])
    return out


# -------------------------------------------------------------- device side

@functools.lru_cache(maxsize=16)
def _stats(device: torch.device):
    """The mean and std on ``device``, copied once: a copy from pageable
    host memory waits for the device's queue."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize_images(img: torch.Tensor) -> torch.Tensor:
    """uint8 (b, h, w, 3) or float [0, 1] -> ImageNet-normalised f32."""
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    mean, std = _stats(img.device)
    return (img - mean) / std


def unnormalize_images(img: torch.Tensor) -> torch.Tensor:
    """Inverse of ``normalize_images`` on f32 images: ``img * std + mean``."""
    mean, std = _stats(img.device)
    return img * std + mean
