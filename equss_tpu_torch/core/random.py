"""Seeding of the host-side generators.

The port's copy of ``equss_tpu/core/random.py``: seeds Python's
``random`` and numpy's global generator, which host-side data code draws
from.  The trainer's ``torch.Generator``s are explicit and seeded from
the config by the ``Trainer`` itself; this touches none of them.
"""
from __future__ import annotations

import random

import numpy as np


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
