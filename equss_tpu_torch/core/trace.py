"""Spans and counters of the program's layers.

``span(name)`` is a ``torch.profiler.record_function`` range while the
profiler records (``train.profile_dir``'s Chrome trace, or a profiler a
caller wraps around ``Predictor`` calls) and one shared null context
otherwise, so that an untraced run pays a flag read per span.  Spans are
off while ``torch.compile`` or ``torch.export`` traces, so that an
exported graph carries no profiler ops.  The program's span names start
with ``equss.``.

Counters are plain integers under a lock, always on: the kernel
wrappers' launches (``launch.<kernel>``, read by ``ops.launch_counts``)
and the bytes ``parallel.mesh.shard_batch`` copies from the host to a
device (``h2d_bytes``), which ``device_prefetch`` counts from its thread.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_counts: Dict[str, int] = {}


def span(name: str):
    """``name``'s range while the profiler records and no compiler
    traces; else the shared null context."""
    if not torch._C._autograd._profiler_enabled() or torch.compiler.is_compiling():
        return _NULL
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counts() -> Dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def reset_counts(prefix: str = "") -> None:
    """Drop the counters whose name starts with ``prefix`` (all of them
    by default)."""
    with _lock:
        for name in [k for k in _counts if k.startswith(prefix)]:
            del _counts[name]
