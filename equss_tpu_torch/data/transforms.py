"""Image normalisation in front of the model, and its inverse.

Counterpart of ``equss_tpu/data/transforms.py::normalize_images``
(ToTensor + ImageNet Normalize), so a request can be raw uint8 or
[0, 1] float RGB, and of ``unnormalize_images``, which gives the dense
CRF its colours back.
"""
from __future__ import annotations

import functools

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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
