"""ctypes bindings to the host permutohedral-lattice CRF.

The port's counterpart of ``equss_tpu/ops/crf_native.py``: the C++
lattice of ``native/permutohedral.cpp`` (the pydensecrf equivalent) filters
approximately, on the host, one image at a time; ``ops/crf.py`` computes
the same mean field exactly on the device.  This serves CPU-only
deployments and cross-checks.

The source is the repository's, as it is; at first use it is compiled
with ``g++ -O3 -std=c++17 -shared -fPIC`` into
``equss_tpu_torch/_build/libpermutohedral-<digest>.so`` (the digest covers
the source and the flags, so an edited source is rebuilt), beside the
CUDA libraries and apart from the JAX package's ``native/build/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from equss_tpu_torch.ops._build import BUILD_DIR
from equss_tpu_torch.ops.crf import CRFConfig

SOURCE = Path(__file__).resolve().parents[2] / "native" / "permutohedral.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"libpermutohedral-{digest}.so"


def _build_library(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build_library(path)
        lib = ctypes.CDLL(str(path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.dense_crf_inference.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, f32p,
        ]
        lib.dense_crf_inference.restype = ctypes.c_int
        lib.permutohedral_filter.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ]
        lib.permutohedral_filter.restype = ctypes.c_int
        _lib = lib
        return lib


def permutohedral_filter(features: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Gaussian filter of ``values`` (n, vd) over ``features`` (n, fd)."""
    lib = load_library()
    features = np.ascontiguousarray(features, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    n, fd = features.shape
    if values.ndim != 2 or values.shape[0] != n:
        raise ValueError(f"values {values.shape} do not match features {features.shape}")
    vd = values.shape[1]
    out = np.empty((n, vd), np.float32)
    rc = lib.permutohedral_filter(features, values, n, fd, vd, out)
    if rc != 0:
        raise RuntimeError(f"permutohedral_filter failed rc={rc}")
    return out


def dense_crf_native(img_rgb255: np.ndarray, log_probs: np.ndarray,
                     cfg: CRFConfig = CRFConfig()) -> np.ndarray:
    """Refined probabilities (H, W, C) by the lattice's mean field:
    ``img_rgb255`` (H, W, 3) floats in [0, 255], ``log_probs`` (H, W, C)
    the log-softmax unary.  ``cfg.block`` and ``cfg.exclude_self`` do not
    apply (the lattice keeps the self term, as pydensecrf does)."""
    lib = load_library()
    H, W, C = log_probs.shape
    if img_rgb255.shape != (H, W, 3):
        raise ValueError(f"image {img_rgb255.shape} does not match log_probs {log_probs.shape}")
    lp = np.ascontiguousarray(log_probs.reshape(H * W, C), np.float32)
    rgb = np.ascontiguousarray(img_rgb255.reshape(H * W, 3), np.float32)
    out = np.empty((H * W, C), np.float32)
    rc = lib.dense_crf_inference(lp, rgb, H, W, C, cfg.max_iter, cfg.pos_w, cfg.pos_xy_std,
                                 cfg.bi_w, cfg.bi_xy_std, cfg.bi_rgb_std, out)
    if rc != 0:
        raise RuntimeError(f"dense_crf_inference failed rc={rc}")
    return out.reshape(H, W, C)


def batched_crf_native(imgs_rgb255: np.ndarray, log_probs: np.ndarray,
                       cfg: CRFConfig = CRFConfig()) -> np.ndarray:
    """``dense_crf_native`` of each image, one after the other."""
    return np.stack([dense_crf_native(imgs_rgb255[i], log_probs[i], cfg)
                     for i in range(len(imgs_rgb255))])
