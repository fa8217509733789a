"""What the port's tools share: the device, its name and clock, and the
config a tool reads.

Every tool takes the card unless ``--device`` says otherwise
(``resolve_device``: without CUDA it raises), names the device in its
result, and times the card with CUDA events or a host clock that ends in
``torch.cuda.synchronize()``.  On the CPU (``--device cpu``, the tests'
tiny shapes) the same code runs the kernels' plain versions, and its
times are the CPU's.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List

import torch

from equss_tpu_torch.device import synchronize

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CONFIG = os.path.join(REPO, "configs", "pqgo_cocostuff27.yaml")


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain "
                         "kernel versions at tiny shapes)")


def add_config_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help="YAML config (default: configs/pqgo_cocostuff27.yaml)")
    ap.add_argument("--override", action="append", default=[],
                    help="extra dotted config override (repeatable), e.g. "
                         "model.pretrained.model_type=vit_micro")


def load_config(path: str, overrides: List[str]) -> dict:
    """The resolved config of ``path`` with the dotted ``overrides``, in
    debug mode (no wandb)."""
    from equss_tpu_torch.core.config import prepare_config

    cfg, _ = prepare_config(["--config", path, "--debug", *overrides])
    return cfg


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def timed_ms(fn: Callable[[], object], iters: int, dev: torch.device, warmup: int = 2) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls after
    ``warmup``: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    synchronize(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters
