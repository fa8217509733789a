"""Metrics sinks: a JSON-lines file and stdout banners.

The port's copy of ``equss_tpu/core/logging.py::MetricsLogger``: with a
``save_dir`` every ``log`` call appends one JSON object (``step`` and the
metrics, as floats where they convert) to ``<save_dir>/metrics.jsonl``,
the JAX package's format.  Its wandb passthrough and ``is_master`` come
with the CLI and multi-GPU slices of the port.
"""
from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, Optional


def time_log() -> str:
    ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    return f"-------------------- {ts} --------------------"


class MetricsLogger:
    def __init__(self, save_dir: Optional[str] = None) -> None:
        self.save_dir = save_dir
        self._file = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._file = open(os.path.join(save_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": step}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def banner(self, msg: str) -> None:
        print(time_log(), flush=True)
        print(msg, flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
