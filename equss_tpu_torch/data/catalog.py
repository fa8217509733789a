"""Dataset catalogs: class maps, colormaps, names.

The port's copy of ``equss_tpu/data/catalog.py``: the published
COCO-Stuff fine->coarse 27-class mapping, the Potsdam mapping, class
counts, class-name lists and colormaps, as numpy lookup tables so that
a label remap is one vectorized gather.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

# fine id (0..181) -> coarse 27-class id
_COCO_FINE_TO_COARSE = {
    0: 9, 1: 11, 2: 11, 3: 11, 4: 11, 5: 11, 6: 11, 7: 11, 8: 11, 9: 8,
    10: 8, 11: 8, 12: 8, 13: 8, 14: 8, 15: 7, 16: 7, 17: 7, 18: 7, 19: 7,
    20: 7, 21: 7, 22: 7, 23: 7, 24: 7, 25: 6, 26: 6, 27: 6, 28: 6, 29: 6,
    30: 6, 31: 6, 32: 6, 33: 10, 34: 10, 35: 10, 36: 10, 37: 10, 38: 10,
    39: 10, 40: 10, 41: 10, 42: 10, 43: 5, 44: 5, 45: 5, 46: 5, 47: 5,
    48: 5, 49: 5, 50: 5, 51: 2, 52: 2, 53: 2, 54: 2, 55: 2, 56: 2, 57: 2,
    58: 2, 59: 2, 60: 2, 61: 3, 62: 3, 63: 3, 64: 3, 65: 3, 66: 3, 67: 3,
    68: 3, 69: 3, 70: 3, 71: 0, 72: 0, 73: 0, 74: 0, 75: 0, 76: 0, 77: 1,
    78: 1, 79: 1, 80: 1, 81: 1, 82: 1, 83: 4, 84: 4, 85: 4, 86: 4, 87: 4,
    88: 4, 89: 4, 90: 4, 91: 17, 92: 17, 93: 22, 94: 20, 95: 20, 96: 22,
    97: 15, 98: 25, 99: 16, 100: 13, 101: 12, 102: 12, 103: 17, 104: 17,
    105: 23, 106: 15, 107: 15, 108: 17, 109: 15, 110: 21, 111: 15,
    112: 25, 113: 13, 114: 13, 115: 13, 116: 13, 117: 13, 118: 22,
    119: 26, 120: 14, 121: 14, 122: 15, 123: 22, 124: 21, 125: 21,
    126: 24, 127: 20, 128: 22, 129: 15, 130: 17, 131: 16, 132: 15,
    133: 22, 134: 24, 135: 21, 136: 17, 137: 25, 138: 16, 139: 21,
    140: 17, 141: 22, 142: 16, 143: 21, 144: 21, 145: 25, 146: 21,
    147: 26, 148: 21, 149: 24, 150: 20, 151: 17, 152: 14, 153: 21,
    154: 26, 155: 15, 156: 23, 157: 20, 158: 21, 159: 24, 160: 15,
    161: 24, 162: 22, 163: 25, 164: 15, 165: 20, 166: 17, 167: 17,
    168: 22, 169: 14, 170: 18, 171: 18, 172: 18, 173: 18, 174: 18,
    175: 18, 176: 18, 177: 26, 178: 26, 179: 19, 180: 19, 181: 24,
}


def coco_fine_to_coarse_lut() -> np.ndarray:
    """LUT of length 256: fine label -> coarse class; unknown/ignore -> -1.

    Usage: ``coarse = lut[np.clip(label, 0, 255)]`` with label==255/-1
    mapping to -1 (ignore).
    """
    lut = np.full(256, -1, np.int32)
    for fine, coarse in _COCO_FINE_TO_COARSE.items():
        lut[fine] = coarse
    return lut


# potsdam fine->coarse
def potsdam_fine_to_coarse_lut() -> np.ndarray:
    lut = np.full(256, -1, np.int32)
    for fine, coarse in {0: 0, 4: 0, 1: 1, 5: 1, 2: 2, 3: 2}.items():
        lut[fine] = coarse
    return lut


# cocostuff3 coarse classes: sky/plant/ground coarse ids
COCOSTUFF3_COARSE_CLASSES = [23, 22, 21]
COCO_FIRST_STUFF_INDEX = 12
CITYSCAPES_FIRST_NON_VOID = 7


def dataset_num_classes(dataset_name: str) -> int:
    """Per-dataset class counts."""
    return {
        "potsdam": 3,
        "cityscapes": 27,
        "cocostuff3": 3,
        "cocostuff15": 15,
        "cocostuff27": 27,
        "pascal": 20,
    }[dataset_name]


def get_class_labels(dataset_name: str) -> List[str]:
    """Class-name lists."""
    if dataset_name.startswith("cityscapes"):
        return [
            "road", "sidewalk", "parking", "rail track", "building",
            "wall", "fence", "guard rail", "bridge", "tunnel",
            "pole", "polegroup", "traffic light", "traffic sign",
            "vegetation", "terrain", "sky", "person", "rider", "car",
            "truck", "bus", "caravan", "trailer", "train",
            "motorcycle", "bicycle",
        ]
    if dataset_name == "cocostuff27":
        return [
            "electronic", "appliance", "food", "furniture", "indoor",
            "kitchen", "accessory", "animal", "outdoor", "person",
            "sports", "vehicle", "ceiling", "floor", "food",
            "furniture", "rawmaterial", "textile", "wall", "window",
            "building", "ground", "plant", "sky", "solid",
            "structural", "water",
        ]
    if dataset_name in ("voc", "pascal"):
        return [
            "background",
            "aeroplane", "bicycle", "bird", "boat", "bottle",
            "bus", "car", "cat", "chair", "cow",
            "diningtable", "dog", "horse", "motorbike", "person",
            "pottedplant", "sheep", "sofa", "train", "tvmonitor",
        ]
    if dataset_name == "potsdam":
        return ["roads and cars", "buildings and clutter",
                "trees and vegetation"]
    raise ValueError(f"Unknown Dataset {dataset_name}")


def create_pascal_label_colormap() -> np.ndarray:
    """Bit-trick VOC colormap."""
    colormap = np.zeros((512, 3), dtype=int)
    ind = np.arange(512, dtype=int)
    for shift in reversed(range(8)):
        for channel in range(3):
            colormap[:, channel] |= ((ind >> channel) & 1) << shift
        ind >>= 3
    return colormap


_CITYSCAPES_COLORS = [
    (128, 64, 128), (244, 35, 232), (250, 170, 160), (230, 150, 140),
    (70, 70, 70), (102, 102, 156), (190, 153, 153), (180, 165, 180),
    (150, 100, 100), (150, 120, 90), (153, 153, 153), (153, 153, 153),
    (250, 170, 30), (220, 220, 0), (107, 142, 35), (152, 251, 152),
    (70, 130, 180), (220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70),
    (0, 60, 100), (0, 0, 90), (0, 0, 110), (0, 80, 100), (0, 0, 230),
    (119, 11, 32), (0, 0, 0),
]


def create_cityscapes_colormap() -> np.ndarray:
    return np.array(_CITYSCAPES_COLORS)


def create_pq_colormap() -> np.ndarray:
    """Extended colormap for per-subspace codeword-index maps."""
    extra = [(128, 0, 128), (0, 128, 128), (255, 102, 0), (153, 204, 0),
             (51, 51, 153)]
    return np.array(_CITYSCAPES_COLORS + extra)
