"""ctypes bindings to the native batched image and label loader.

The port's counterpart of ``equss_tpu/data/native_loader.py``: a C++
thread pool decodes JPEG and PNG files, resizes them NEAREST (shorter
side, then a center crop; or an exact (res, res) stretch), pixel for
pixel as ``transforms.load_image`` / ``load_label`` do with PIL, and
releases the GIL throughout.  Labels decode to their raw single channel
(gray values or palette indices), as ``np.asarray(Image.open(png))``.

The source is the repository's ``native/imageloader.cpp`` as it is; at
first use it is compiled with ``g++ -O3 -std=c++17 -shared -fPIC ...
-ljpeg -lpng -lpthread`` into
``equss_tpu_torch/_build/libimageloader-<digest>.so`` (the digest covers
the source and the flags), apart from the JAX package's ``native/build/``.
A failed build or load is remembered, so ``dataloader.*.native: auto``
tries it once per process.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from equss_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "imageloader.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_MODES = {"center": 0, "none": 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[Exception] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"libimageloader-{digest}.so"


def _build_library(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                           str(SOURCE), *LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises the first
    failure again on every later call."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise _load_error
        try:
            path = library_path()
            if not path.exists():
                _build_library(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError) as e:
            _load_error = e
            raise
        u8out = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        for fn in (lib.load_image_batch2, lib.load_label_batch):
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, u8out]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """True if the library loads (built on demand)."""
    try:
        load_library()
        return True
    except (OSError, RuntimeError):
        return False


def _paths_array(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def load_image_batch(paths: Sequence[str], res: int, n_threads: int = 4,
                     mode: str = "center") -> np.ndarray:
    """Decode + resize + crop a batch of images -> (n, res, res, 3) uint8.
    ``center``: shorter side to res, then a center crop; ``none``: an
    exact (res, res) stretch.  Raises IOError if any file fails."""
    lib = load_library()
    n = len(paths)
    out = np.empty((n, res, res, 3), np.uint8)
    failures = lib.load_image_batch2(_paths_array(paths), n, res, _MODES[mode], n_threads, out)
    if failures:
        raise IOError(f"native loader failed on {failures}/{n} images")
    return out


def load_label_batch(paths: Sequence[str], res: int, n_threads: int = 4,
                     mode: str = "center") -> np.ndarray:
    """Decode + resize + crop a batch of label maps -> (n, res, res) uint8
    (raw gray values or palette indices).  Raises IOError if any file
    fails, a 16-bit label among them."""
    lib = load_library()
    n = len(paths)
    out = np.empty((n, res, res), np.uint8)
    failures = lib.load_label_batch(_paths_array(paths), n, res, _MODES[mode], n_threads, out)
    if failures:
        raise IOError(f"native loader failed on {failures}/{n} labels")
    return out
