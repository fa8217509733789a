"""Packed decoded-corpus cache: decode the corpus once, slice forever.

The port's copy of ``equss_tpu/data/cache.py``, in the same format, so
that a pack written by either package reads in the other.  One pass
decodes and NEAREST-resizes every image and label to the training
``res`` and appends the raw uint8 pixels to one flat ``.bin`` with an
``.npz`` index; an epoch then memory-maps the blob and serves items by
numpy slices, with no image codec on the hot path.

The packed arrays are ``np.asarray(resize_shorter_np(Image.open(...)))``
and the crop (center or random) is applied at load time as
``_SegDataset._load_pair`` applies it, so batches are bit-identical to
the decoding path.  Two geometries, chosen by the loader crop type at
pack time: ``shorter`` (shorter side = res; center and random crops at
load) and ``stretch`` (exactly (res, res); loader crop ``none``).

The index carries a hash of the corpus file list: a pack is refused if
the dataset it is asked to serve lists other files.
"""
from __future__ import annotations

import hashlib
import os
from os.path import join
from typing import Any, Dict, Optional

import numpy as np

PACK_VERSION = 2


def _file_list_hash(image_files, label_files) -> str:
    """Corpus identity = the trailing 4 path components of every file —
    deep enough to include the corpus directory (e.g. the crop-ratio-
    bearing ``cocostuff27_five_crop_0.5/img/train/0.jpg``), shallow
    enough to survive a data_dir move.  Basenames alone could not tell
    two CroppedDataset corpora of different crop_ratio apart (both list
    ``0.jpg..N-1.jpg``)."""
    h = hashlib.sha1()
    for p in list(image_files) + list(label_files):
        h.update("/".join(os.path.normpath(p).split(os.sep)[-4:]).encode())
    return h.hexdigest()[:16]


def default_pack_base(data_dir: str, dataset_name: str, mode: str,
                      crop_type: Optional[str], res: int,
                      crop_ratio: float = 0.5) -> str:
    """Pack file base path (no extension) under data_dir/packed/, named
    like the kNN cache.  Cropped corpora (crop_type five/double) carry
    their crop_ratio, so ratio variants get distinct packs."""
    crop = (f"{crop_type}_{crop_ratio}" if crop_type not in (None, "none")
            else str(crop_type))
    return join(data_dir, "packed",
                f"pack_{dataset_name}_{mode}_{crop}_{res}")


def pack_dataset(dataset, out_base: str, *, limit: Optional[int] = None,
                 log_every: int = 2000) -> str:
    """Decode + resize every item of a file-backed ``_SegDataset`` into
    ``out_base + '.bin'`` / ``'.npz'``.  Returns the ``.bin`` path."""
    from PIL import Image

    from equss_tpu_torch.data.transforms import resize_shorter_np

    if not (hasattr(dataset, "image_files")
            and hasattr(dataset, "label_files")):
        raise ValueError("pack_dataset needs a file-backed dataset "
                         "(image_files/label_files)")
    geom = "stretch" if dataset.crop_type in (None, "none") else "shorter"
    res = dataset.res
    target = (res, res) if geom == "stretch" else res

    n = len(dataset.image_files) if limit is None \
        else min(limit, len(dataset.image_files))
    os.makedirs(os.path.dirname(out_base) or ".", exist_ok=True)
    bin_path, idx_path = out_base + ".bin", out_base + ".npz"
    offsets = np.zeros(n + 1, np.int64)
    heights = np.zeros(n, np.int32)
    widths = np.zeros(n, np.int32)
    with open(bin_path + ".tmp", "wb") as f:
        for i in range(n):
            img = Image.open(dataset.image_files[i]).convert("RGB")
            img = np.asarray(resize_shorter_np(img, target), np.uint8)
            lbl = np.asarray(resize_shorter_np(
                Image.open(dataset.label_files[i]), target))
            if lbl.dtype != np.uint8 and (lbl.min() < 0 or lbl.max() > 255):
                # e.g. 16-bit 'I'-mode label PNGs: a uint8 pack would
                # silently corrupt ids — refuse instead
                raise ValueError(
                    f"label values outside uint8 at "
                    f"{dataset.label_files[i]}; packing unsupported")
            lbl = lbl.astype(np.uint8)
            if img.shape[:2] != lbl.shape[:2]:
                raise ValueError(
                    f"image/label shape mismatch at {i}: "
                    f"{img.shape} vs {lbl.shape}")
            h, w = img.shape[:2]
            heights[i], widths[i] = h, w
            f.write(img.tobytes())
            f.write(lbl.tobytes())
            offsets[i + 1] = offsets[i] + h * w * 4   # 3 img + 1 label
            if log_every and (i + 1) % log_every == 0:
                print(f"[pack] {i + 1}/{n}")
    np.savez(idx_path + ".tmp.npz", offsets=offsets, heights=heights,
             widths=widths, res=res, geom=geom, version=PACK_VERSION,
             files_hash=_file_list_hash(dataset.image_files[:n],
                                        dataset.label_files[:n]))
    os.replace(bin_path + ".tmp", bin_path)
    os.replace(idx_path + ".tmp.npz", idx_path)
    return bin_path


class PackedDataset:
    """Serve a file-backed ``_SegDataset``'s items from a pack.

    Mirrors the ``get(index, rng)`` contract (same crop draws, same
    remap, same item dict) while replacing decode with memmap slices.
    """

    def __init__(self, base, pack_base: str) -> None:
        idx = np.load(pack_base + ".npz")
        if int(idx["version"]) != PACK_VERSION:
            raise ValueError(f"pack version {idx['version']} != "
                             f"{PACK_VERSION}: repack {pack_base}")
        if int(idx["res"]) != base.res:
            raise ValueError(f"pack res {idx['res']} != dataset res "
                             f"{base.res}")
        geom = str(idx["geom"])
        want = "stretch" if base.crop_type in (None, "none") else "shorter"
        if geom != want:
            raise ValueError(f"pack geometry {geom} does not serve "
                             f"loader crop '{base.crop_type}'")
        n = len(idx["heights"])
        if n != len(base.image_files):
            raise ValueError(f"pack has {n} items, dataset lists "
                             f"{len(base.image_files)}")
        if str(idx["files_hash"]) != _file_list_hash(base.image_files,
                                                     base.label_files):
            raise ValueError("pack was built from a different file list")
        self.base = base
        self.res = base.res
        self.crop_type = base.crop_type
        self.image_files = base.image_files
        self.label_files = base.label_files
        self.offsets = idx["offsets"]
        self.heights = idx["heights"]
        self.widths = idx["widths"]
        self.blob = np.memmap(pack_base + ".bin", np.uint8, "r")
        if self.blob.size != int(self.offsets[-1]):
            raise ValueError("pack .bin size does not match its index")

    def __len__(self) -> int:
        return len(self.heights)

    def raw(self, index: int):
        """(img (h, w, 3) u8 view, label (h, w) u8 view) pre-crop."""
        off = int(self.offsets[index])
        h, w = int(self.heights[index]), int(self.widths[index])
        img = self.blob[off: off + h * w * 3].reshape(h, w, 3)
        lbl = self.blob[off + h * w * 3: off + h * w * 4].reshape(h, w)
        return img, lbl

    def remap_label(self, label: np.ndarray) -> np.ndarray:
        return self.base.remap_label(label)

    def get(self, index: int,
            rng: Optional[np.random.RandomState] = None) -> Dict[str, Any]:
        from equss_tpu_torch.data.transforms import center_crop_np

        img, lbl = self.raw(index)
        res = self.res
        if self.crop_type in (None, "none"):
            pass                                   # already (res, res)
        elif self.crop_type == "center":
            img, lbl = center_crop_np(img, res), center_crop_np(lbl, res)
        elif self.crop_type == "random":
            # same two draws, same dims as _SegDataset._load_pair
            rng = self.base.rng if rng is None else rng
            h, w = img.shape[:2]
            top = rng.randint(0, max(h - res, 0) + 1)
            left = rng.randint(0, max(w - res, 0) + 1)
            img = img[top: top + res, left: left + res]
            lbl = lbl[top: top + res, left: left + res]
        else:
            raise ValueError(f"Unknown Cropper {self.crop_type}")
        label = self.base.remap_label(np.asarray(lbl, np.int32))
        return {"img": np.ascontiguousarray(img),
                "label": label.astype(np.int32),
                "img_path": self.image_files[index], "index": index}

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.get(index, getattr(self.base, "rng", None))
