"""Torch-semantics image resizing as two f32 matrix products.

The port's own copy of the interpolation matrices of
``equss_tpu/ops/resize.py`` (``_linear_matrix``, ``_cubic_matrix``,
``resize2d``): a 1-D resize is a linear map, so the (out, in) matrix is
built once in numpy and applied along H and then W.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) bilinear interpolation matrix, torch semantics."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = np.zeros(1) if out_size == 1 else i * (in_size - 1) / (out_size - 1)
    else:
        src = (i + 0.5) * in_size / out_size - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    mat = np.zeros((out_size, in_size))
    mat[np.arange(out_size), lo] += 1.0 - w_hi
    mat[np.arange(out_size), hi] += w_hi
    return mat.astype(np.float32)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with torch's a = -0.75."""
    ax = np.abs(x)
    return np.where(
        ax <= 1,
        (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _cubic_matrix(in_size: int, out_size: int, align_corners: bool = False,
                  scale_factor: Optional[float] = None) -> np.ndarray:
    """(out, in) bicubic matrix, torch semantics (border-clamped taps).
    ``scale_factor`` reproduces ``F.interpolate(scale_factor=s,
    recompute_scale_factor=False)``: src = (i + 0.5) / s - 0.5."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = i * (in_size - 1) / max(out_size - 1, 1)
    elif scale_factor is not None:
        src = (i + 0.5) / scale_factor - 0.5
    else:
        src = (i + 0.5) * in_size / out_size - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    mat = np.zeros((out_size, in_size))
    for tap in range(-1, 3):
        w = _cubic_kernel(tap - frac)
        idx = np.clip(lo + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), w)
    return mat.astype(np.float32)


def resize2d(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear",
             align_corners: bool = False,
             scale_factor: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Resize NHWC ``x`` to ``size = (H, W)`` with torch semantics
    (``bilinear`` or ``bicubic``), in f32."""
    _, H, W, _ = x.shape
    out_h, out_w = size
    sf_h, sf_w = scale_factor if scale_factor is not None else (None, None)
    if method == "bilinear":
        mh = _linear_matrix(H, out_h, align_corners)
        mw = _linear_matrix(W, out_w, align_corners)
    elif method == "bicubic":
        mh = _cubic_matrix(H, out_h, align_corners, sf_h)
        mw = _cubic_matrix(W, out_w, align_corners, sf_w)
    else:
        raise ValueError(f"Unsupported resize method {method}")
    x = x.float()
    mh = torch.from_numpy(mh).to(x.device)
    mw = torch.from_numpy(mw).to(x.device)
    out = torch.einsum("oh,nhwc->nowc", mh, x)
    return torch.einsum("ow,nhwc->nhoc", mw, out)
