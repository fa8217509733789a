"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given they take CUDA, and without CUDA they raise instead of
silently continuing on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def launch_stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, as a
    kernel launch takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                      device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor
    on CUDA (on ``device`` when given): what the kernels take."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must be on {device or 'a CUDA device'}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
