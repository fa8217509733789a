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
  ``unnormalize_images``, which gives the dense CRF its colours back;
  ``photometric_aug``, the batched ColorJitter + RandomGrayscale +
  GaussianBlur view of the variants that consume one, in two parts:
  ``photometric_draws`` draws each image's factors from a generator on
  the device and ``photometric_apply`` applies them.

PIL is imported where a file is decoded, so the module imports without
it.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

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


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return (img * w).sum(-1, keepdim=True)


def _rgb_to_hsv(img: torch.Tensor):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(-1)
    minc = img.amin(-1)
    deltac = maxc - minc
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    s = torch.where(maxc > 0, deltac / maxc.clamp_min(1e-12), zero)
    dz = deltac.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / dz, (maxc - g) / dz, (maxc - b) / dz
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(deltac == 0, zero, h)
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    conds = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = []
    for c in range(3):
        x = conds[5][c]                  # i is in [0, 6): case 5 is what is left
        for k in range(4, -1, -1):
            x = torch.where(i == k, conds[k][c], x)
        out.append(x)
    return torch.stack(out, -1)


def photometric_draws(generator: torch.Generator, b: int, device, *,
                      brightness: float = 0.3, contrast: float = 0.3,
                      saturation: float = 0.3, hue: float = 0.1,
                      grayscale_p: float = 0.2, blur_p: float = 0.5,
                      blur_sigma: Tuple[float, float] = (3.0, 3.0)) -> Dict[str, torch.Tensor]:
    """Each image's factors of ``photometric_apply``, drawn from
    ``generator`` on ``device``: brightness, contrast and saturation
    factors (b, 1, 1, 1) uniform in 1 -+ their strength, the hue shift
    (b, 1, 1) uniform in -+hue, the grayscale and blur coins (b, 1, 1, 1)
    and the blur's sigma (b,)."""
    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)

    return {
        "brightness": uniform((b, 1, 1, 1), 1 - brightness, 1 + brightness),
        "contrast": uniform((b, 1, 1, 1), 1 - contrast, 1 + contrast),
        "saturation": uniform((b, 1, 1, 1), 1 - saturation, 1 + saturation),
        "hue": uniform((b, 1, 1), -hue, hue),
        "to_gray": torch.rand((b, 1, 1, 1), generator=generator, device=device) < grayscale_p,
        "sigma": uniform((b,), blur_sigma[0], blur_sigma[1]),
        "blur": torch.rand((b, 1, 1, 1), generator=generator, device=device) < blur_p,
    }


def photometric_apply(img: torch.Tensor, draws: Dict[str, torch.Tensor],
                      blur_kernel: int = 3) -> torch.Tensor:
    """(b, h, w, 3) images in [0, 1] -> the jittered view: brightness,
    contrast against the image's mean gray, saturation against each
    pixel's gray, a hue shift in HSV, grayscale where drawn, then a
    separable Gaussian blur with edge padding where drawn; each step
    clipped to [0, 1] as in the JAX package."""
    img = torch.clamp(img * draws["brightness"], 0.0, 1.0)
    fc = draws["contrast"]
    mean_gray = _rgb_to_gray(img).mean(dim=(1, 2), keepdim=True)
    img = torch.clamp(fc * img + (1 - fc) * mean_gray, 0.0, 1.0)
    fs = draws["saturation"]
    img = torch.clamp(fs * img + (1 - fs) * _rgb_to_gray(img), 0.0, 1.0)
    h, s, v = _rgb_to_hsv(img)
    img = torch.clamp(_hsv_to_rgb(torch.remainder(h + draws["hue"], 1.0), s, v), 0.0, 1.0)
    img = torch.where(draws["to_gray"], _rgb_to_gray(img).expand_as(img), img)

    half = blur_kernel // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    k1d = torch.exp(-0.5 * (x[None, :] / draws["sigma"][:, None].clamp_min(1e-6)) ** 2)
    k1d = k1d / k1d.sum(-1, keepdim=True)                     # (b, kernel)
    H, W = img.shape[1:3]
    kb = k1d[:, :, None, None, None]
    im_p = torch.cat([img[:, :1]] * half + [img] + [img[:, -1:]] * half, 1)
    im_h = sum(kb[:, i] * im_p[:, i:i + H] for i in range(blur_kernel))
    im_p = torch.cat([im_h[:, :, :1]] * half + [im_h] + [im_h[:, :, -1:]] * half, 2)
    blurred = sum(kb[:, i] * im_p[:, :, i:i + W] for i in range(blur_kernel))
    return torch.where(draws["blur"], blurred, img)


def photometric_aug(generator: torch.Generator, img: torch.Tensor, *,
                    blur_kernel: int = 3, **factors) -> torch.Tensor:
    """Batched ColorJitter + RandomGrayscale + GaussianBlur of (b, h, w, 3)
    images in [0, 1], one independent draw per image from ``generator``
    (on the images' device); ``factors`` are ``photometric_draws``'s
    keyword arguments."""
    draws = photometric_draws(generator, img.shape[0], img.device, **factors)
    return photometric_apply(img, draws, blur_kernel)
