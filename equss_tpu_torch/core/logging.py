"""Metrics sinks: a JSON-lines file and stdout banners.

The port's copy of ``equss_tpu/core/logging.py::MetricsLogger``: with a
``save_dir`` every ``log`` call appends one JSON object (``step`` and the
metrics, as floats where they convert) to ``<save_dir>/metrics.jsonl``,
the JAX package's format.  ``use_wandb`` also passes each call to wandb
(``wandb.init(**wandb_cfg)``), imported when asked for and optional: the
JSONL file stays the record.  A logger with ``is_master=False`` (any
process but the first of a multi-process run) writes nothing.

``count_params`` and ``compute_param_norm`` are the counterparts of the
JAX package's helpers of the same names, over an ``nn.Module`` (its
parameters) or a dict of tensors.
"""
from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn


def time_log() -> str:
    ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    return f"-------------------- {ts} --------------------"


class MetricsLogger:
    def __init__(self, save_dir: Optional[str] = None, use_wandb: bool = False,
                 wandb_cfg: Optional[Dict[str, Any]] = None,
                 is_master: bool = True) -> None:
        self.is_master = is_master
        self.save_dir = save_dir
        self._file = None
        self._wandb = None
        if not is_master:
            return
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._file = open(os.path.join(save_dir, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("[logging] wandb not available; JSONL sink only")
            else:
                self._wandb = wandb
                wandb.init(**(wandb_cfg or {}))

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if not self.is_master:
            return
        record = {"step": step}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def banner(self, msg: str) -> None:
        if self.is_master:
            print(time_log(), flush=True)
            print(msg, flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


def _tensors(tree: Union[nn.Module, Mapping[str, Any]]):
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    out = []
    for v in tree.values():
        out.extend(_tensors(v) if isinstance(v, Mapping) else [v])
    return out


def count_params(tree: Union[nn.Module, Mapping[str, Any]]) -> int:
    """The number of parameter values: an ``nn.Module``'s parameters, or
    every tensor of a (nested) dict."""
    return sum(int(t.numel()) for t in _tensors(tree))


def compute_param_norm(tree: Union[nn.Module, Mapping[str, Any]]) -> float:
    """The global L2 norm over the same tensors, summed in f32 on their
    device."""
    tensors = _tensors(tree)
    if not tensors:
        return 0.0
    return float(torch.sqrt(sum((t.detach().float() ** 2).sum() for t in tensors)))
