"""Datasets: COCO-Stuff, Cityscapes, Potsdam, Pascal VOC and the cropped
corpora, read from their on-disk layouts.

Counterpart of ``equss_tpu/data/datasets.py``.  Each item is a dict of
numpy arrays: ``img`` (res, res, 3) uint8, ``label`` (res, res) int32
(ignore = -1), ``img_path`` and ``index``.  Images stay uint8 on the
host; /255 and the ImageNet normalisation run on the device
(``transforms.normalize_images``).

``get(index, rng)`` takes an explicit ``np.random.RandomState`` for any
random crop, so that items decode deterministically in any thread and
order: the pipeline hands every item a RandomState of its own seed.
PIL (and scipy, for Potsdam's ``.mat`` tiles) is imported where a file
is decoded.
"""
from __future__ import annotations

import os
from os.path import join
from typing import Any, Dict, List, Optional

import numpy as np

from equss_tpu_torch.data.catalog import (
    CITYSCAPES_FIRST_NON_VOID,
    COCO_FIRST_STUFF_INDEX,
    COCOSTUFF3_COARSE_CLASSES,
    coco_fine_to_coarse_lut,
    potsdam_fine_to_coarse_lut,
)
from equss_tpu_torch.data.transforms import (
    load_image,
    load_label,
    prepare_image,
    resize_shorter_np,
)


class _SegDataset:
    """Base: subclasses provide ``image_files`` / ``label_files`` and
    ``remap_label``."""

    def __init__(self, res: int, crop_type: str = "center", seed: int = 0) -> None:
        self.res = res
        self.crop_type = crop_type
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.image_files)

    def _load_pair(self, img_path: str, label_path: Optional[str],
                   rng: Optional[np.random.RandomState] = None):
        rng = self.rng if rng is None else rng
        if self.crop_type == "random":
            from PIL import Image

            # one crop window for image and label: two draws, top then left
            img_pil = Image.open(img_path).convert("RGB")
            w, h = resize_shorter_np(img_pil, self.res).size
            top = rng.randint(0, max(h - self.res, 0) + 1)
            left = rng.randint(0, max(w - self.res, 0) + 1)
            img = prepare_image(img_pil, self.res, "random", crop_coords=(top, left))
            label = (load_label(label_path, self.res, "random", crop_coords=(top, left))
                     if label_path else None)
        else:
            img = load_image(img_path, self.res, self.crop_type)
            label = load_label(label_path, self.res, self.crop_type) if label_path else None
        if label is None:
            label = np.full(img.shape[:2], -1, np.int32)
        return img, label

    def remap_label(self, label: np.ndarray) -> np.ndarray:
        return label

    def get(self, index: int, rng: Optional[np.random.RandomState] = None) -> Dict[str, Any]:
        """The item at ``index``, any random crop drawn from ``rng``
        (``self.rng`` when None)."""
        img, label = self._load_pair(self.image_files[index], self.label_files[index], rng)
        label = self.remap_label(label)
        return {"img": img, "label": label.astype(np.int32),
                "img_path": self.image_files[index], "index": index}

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.get(index, self.rng)


class CocoSeg(_SegDataset):
    """COCO-Stuff from its curated image lists, labels mapped fine ->
    coarse (27 classes); ``coarse_labels`` gives cocostuff3,
    ``exclude_things`` the stuff classes only (cocostuff15)."""

    def __init__(self, mode: str, data_dir: str, res: int, crop_type: str = "center",
                 coarse_labels: bool = False, exclude_things: bool = False,
                 subset: Optional[int] = None, seed: int = 0) -> None:
        super().__init__(res, crop_type, seed)
        if mode not in ("train", "val", "train+val"):
            raise ValueError(f"CocoSeg mode {mode!r} not in train|val|train+val")
        split_dirs = {"train": ["train2017"], "val": ["val2017"],
                      "train+val": ["train2017", "val2017"]}
        lists = {None: "Coco164kFull_Stuff_Coarse.txt", 6: "Coco164kFew_Stuff_6.txt",
                 7: "Coco164kFull_Stuff_Coarse_7.txt"}
        if subset not in lists:
            raise ValueError(f"Unknown subset {subset}")
        self.image_files: List[str] = []
        self.label_files: List[str] = []
        for split_dir in split_dirs[mode]:
            with open(join(data_dir, "curated", split_dir, lists[subset])) as f:
                for img_id in (x.rstrip() for x in f):
                    self.image_files.append(join(data_dir, "images", split_dir, img_id + ".jpg"))
                    self.label_files.append(
                        join(data_dir, "annotations", split_dir, img_id + ".png"))
        self.coarse_labels = coarse_labels
        self.exclude_things = exclude_things
        self.lut = coco_fine_to_coarse_lut()

    def remap_label(self, label: np.ndarray) -> np.ndarray:
        coarse = self.lut[np.clip(label, 0, 255)]
        if self.coarse_labels:     # cocostuff3
            out = np.full_like(coarse, -1)
            for i, c in enumerate(COCOSTUFF3_COARSE_CLASSES):
                out[coarse == c] = i
            return out
        if self.exclude_things:
            out = coarse - COCO_FIRST_STUFF_INDEX
            out[coarse < COCO_FIRST_STUFF_INDEX] = -1
            return out
        return coarse


class CityscapesSeg(_SegDataset):
    """Cityscapes semantic labels, 27 classes after the 7 void ids, read
    from the ``leftImg8bit`` / ``gtFine`` (``gtCoarse`` for train_extra)
    layout."""

    def __init__(self, mode: str, data_dir: str, res: int, crop_type: str = "center",
                 seed: int = 0) -> None:
        super().__init__(res, crop_type, seed)
        if mode not in ("train", "val", "train_extra"):
            raise ValueError(f"CityscapesSeg mode {mode!r} not in train|val|train_extra")
        quality = "gtCoarse" if mode == "train_extra" else "gtFine"
        img_root = join(data_dir, "leftImg8bit", mode)
        lbl_root = join(data_dir, quality, mode)
        self.image_files, self.label_files = [], []
        for city in sorted(os.listdir(img_root)):
            for fn in sorted(os.listdir(join(img_root, city))):
                self.image_files.append(join(img_root, city, fn))
                self.label_files.append(join(
                    lbl_root, city, fn.replace("_leftImg8bit.png", f"_{quality}_labelIds.png")))

    def remap_label(self, label: np.ndarray) -> np.ndarray:
        out = label - CITYSCAPES_FIRST_NON_VOID
        out[out < 0] = -1
        return out


class Potsdam(_SegDataset):
    """Potsdam aerial tiles from ``imgs/<id>.mat`` and ``gt/<id>.mat``
    (a missing ground truth is all ignore), listed by the split files."""

    def __init__(self, mode: str, data_dir: str, res: int, crop_type: str = "center",
                 coarse_labels: bool = True, seed: int = 0) -> None:
        super().__init__(res, crop_type, seed)
        split_files = {
            "train": ["labelled_train.txt"],
            "unlabelled_train": ["unlabelled_train.txt"],
            "val": ["labelled_test.txt"],
            "train+val": ["labelled_train.txt", "labelled_test.txt"],
            "all": ["all.txt"],
        }
        self.root = data_dir
        self.files: List[str] = []
        for sf in split_files[mode]:
            with open(join(data_dir, sf)) as f:
                self.files.extend(x.rstrip() for x in f)
        self.coarse_labels = coarse_labels
        self.lut = potsdam_fine_to_coarse_lut()

    def __len__(self) -> int:
        return len(self.files)

    def get(self, index: int, rng: Optional[np.random.RandomState] = None) -> Dict[str, Any]:
        from PIL import Image
        from scipy.io import loadmat

        rng = self.rng if rng is None else rng
        fid = self.files[index]
        img_arr = loadmat(join(self.root, "imgs", fid + ".mat"))["img"][..., :3]
        img_pil = Image.fromarray(img_arr.astype(np.uint8))
        try:
            lbl_arr = loadmat(join(self.root, "gt", fid + ".mat"))["gt"]
            lbl_pil = Image.fromarray(lbl_arr.astype(np.uint8))
        except FileNotFoundError:
            lbl_pil = Image.fromarray(np.ones(img_arr.shape[:2], np.uint8) * 255)
        img = prepare_image(img_pil, self.res, self.crop_type, rng)
        label = load_label(lbl_pil, self.res, self.crop_type, rng)
        if self.coarse_labels:
            label = self.lut[np.clip(label, 0, 255)]
        return {"img": img, "label": label.astype(np.int32), "img_path": fid, "index": index}

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.get(index, self.rng)


class CroppedDataset(_SegDataset):
    """A corpus the crop job wrote (``jobs.materialize_crops``):
    ``cropped/<name>_<type>_crop_<ratio>/img|label/<mode>/<i>.jpg|png``,
    labels stored +1 so that 0 is ignore."""

    def __init__(self, mode: str, data_dir: str, dataset_name: str, res: int,
                 crop_type_load: str = "five", crop_ratio: float = 0.5,
                 crop_type: str = "center", seed: int = 0) -> None:
        super().__init__(res, crop_type, seed)
        self.data_dir = join(data_dir, "cropped",
                             f"{dataset_name}_{crop_type_load}_crop_{crop_ratio}")
        self.img_dir = join(self.data_dir, "img", mode)
        self.label_dir = join(self.data_dir, "label", mode)
        n = len(os.listdir(self.img_dir))
        if n != len(os.listdir(self.label_dir)):
            raise ValueError(f"{self.img_dir} and {self.label_dir} hold different counts")
        self.image_files = [join(self.img_dir, f"{i}.jpg") for i in range(n)]
        self.label_files = [join(self.label_dir, f"{i}.png") for i in range(n)]

    def remap_label(self, label: np.ndarray) -> np.ndarray:
        return label - 1


class Pascal(_SegDataset):
    """Pascal VOC ``SegmentationClass`` (255 -> ignore)."""

    def __init__(self, mode: str, data_dir: str, res: int, crop_type: str = "center",
                 seed: int = 0) -> None:
        super().__init__(res, crop_type, seed)
        if mode not in ("train", "val"):
            raise ValueError(f"Pascal mode {mode!r} not in train|val")
        with open(join(data_dir, "ImageSets", "Segmentation", mode + ".txt")) as f:
            samples = [x.strip() for x in f]
        self.image_files = [join(data_dir, "JPEGImages", s + ".jpg") for s in samples]
        self.label_files = [join(data_dir, "SegmentationClass", s + ".png") for s in samples]

    def remap_label(self, label: np.ndarray) -> np.ndarray:
        out = label.copy()
        out[out == 255] = -1
        return out


def build_base_dataset(dataset_name: str, mode: str, data_dir: str, res: int,
                       crop_type: Optional[str], crop_ratio: float = 0.5,
                       loader_crop_type: str = "center", seed: int = 0):
    """The dataset of ``dataset_name``: ``crop_type`` (five, random) names
    a cropped corpus for cityscapes and cocostuff27; ``loader_crop_type``
    is the crop at load time."""
    if dataset_name == "potsdam":
        return Potsdam(mode, data_dir, res, loader_crop_type, True, seed)
    if dataset_name == "cityscapes" and crop_type is None:
        return CityscapesSeg(mode, data_dir, res, loader_crop_type, seed)
    if dataset_name == "cityscapes":
        return CroppedDataset(mode, data_dir, "cityscapes", res, crop_type, crop_ratio,
                              loader_crop_type, seed)
    if dataset_name == "cocostuff3":
        return CocoSeg(mode, data_dir, res, loader_crop_type, coarse_labels=True,
                       exclude_things=True, subset=6, seed=seed)
    if dataset_name == "cocostuff15":
        return CocoSeg(mode, data_dir, res, loader_crop_type, coarse_labels=False,
                       exclude_things=True, subset=7, seed=seed)
    if dataset_name == "cocostuff27" and crop_type not in (None, "none"):
        return CroppedDataset(mode, data_dir, "cocostuff27", res, crop_type, crop_ratio,
                              loader_crop_type, seed)
    if dataset_name == "cocostuff27":
        subset = 7 if mode == "val" else None
        return CocoSeg(mode, data_dir, res, loader_crop_type, coarse_labels=False,
                       exclude_things=False, subset=subset, seed=seed)
    if dataset_name == "pascal":
        return Pascal(mode, data_dir, res, loader_crop_type, seed)
    raise ValueError(f"Unknown dataset: {dataset_name}")
