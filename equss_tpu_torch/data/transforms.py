"""Image normalisation in front of the model.

Counterpart of ``equss_tpu/data/transforms.py::normalize_images``
(ToTensor + ImageNet Normalize), so a request can be raw uint8 or
[0, 1] float RGB.
"""
from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(img: torch.Tensor) -> torch.Tensor:
    """uint8 (b, h, w, 3) or float [0, 1] -> ImageNet-normalised f32."""
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img - mean) / std
