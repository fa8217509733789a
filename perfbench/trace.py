"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
requests or steps, reduced to a summary that the per-layer readers
(``metrics/``) and the result's ``breakdown`` read.

Host spans are the benchmark's own ``record_function`` ranges around its
calls into the program (``request.copy_in``, ``request.predict``,
``request.copy_out``; ``step.batch``, ``step.train_step``).  Program spans
are the program's ``equss.*`` ranges around its layers
(``equss_tpu_torch/core/trace.py``), on while the profiler records; they
are kept apart, so that what reads the host spans (the idle gaps, the
breakdown) reads them alone.  Device events are the kernels, copies and
memsets the profiler saw on the card, each with the start of the runtime
call that launched it.  The busy time is the union of their intervals,
so that streams that overlap are not counted twice.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

SPAN_PREFIXES = ("request.", "step.")
PROGRAM_PREFIX = "equss."
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def span(name: str, on: bool):
    """A host span under the profiler, or nothing in an untraced run."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def event_kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def profile_slice(body: Callable[[], Dict[str, Any]], device: torch.device
                  ) -> Dict[str, Any]:
    """Run ``body`` (which returns the slice's counts) under the profiler;
    returns those counts with ``slice_s`` (its wall seconds, synchronised
    at both ends) and, on one time base in µs: the device events
    ``(name, start, end, kind)``; ``launch_us``, for each device event in
    that order the start of the runtime call that launched it (None where
    the profiler saw none); the benchmark's ``host_spans`` and the
    program's ``program_spans`` ``(name, start, end)``; the ``blocking``
    runtime calls ``(name, start)``.  ``counters`` is the change in the
    program's counters (``core.trace.counts()``) over the slice."""
    from torch.profiler import ProfilerActivity, profile

    from equss_tpu_torch.core import trace as program

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = program.counts()
    with profile(activities=activities) as prof:
        with torch.profiler.record_function("slice"):
            t0 = time.perf_counter()
            counts = body()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            slice_s = time.perf_counter() - t0
    after = program.counts()
    dev_events: List[Tuple[str, float, float, str, int]] = []
    spans: List[Tuple[str, float, float]] = []
    program_spans: List[Tuple[str, float, float]] = []
    launches: Dict[int, float] = {}
    blocking: List[Tuple[str, float]] = []
    slice_range = None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        # the profiler mirrors each host span onto the device's timeline as
        # an annotation: that is no work of the device
        ours = e.name == "slice" or e.name.startswith((*SPAN_PREFIXES, PROGRAM_PREFIX))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not ours and not getattr(e, "is_user_annotation", False):
                # the runtime call that launched it has the same id
                dev_events.append((e.name, start, end, event_kind(e.name),
                                   getattr(e, "linked_correlation_id", 0) or e.id))
        elif e.name == "slice":
            slice_range = (start, end)
        elif e.name.startswith(SPAN_PREFIXES):
            spans.append((e.name, start, end))
        elif e.name.startswith(PROGRAM_PREFIX):
            program_spans.append((e.name, start, end))
        elif e.name.startswith("cu"):
            launches[e.id] = start
            if e.name in BLOCKING:
                blocking.append((e.name, start))
    dev_events.sort(key=lambda e: e[1])
    counters = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return {**counts, "slice_s": slice_s, "slice_range_us": slice_range,
            "device_events": [e[:4] for e in dev_events],
            "launch_us": [launches.get(e[4]) for e in dev_events],
            "host_spans": spans, "program_spans": program_spans, "blocking": blocking,
            "counters": counters}


def busy_intervals(events) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, sorted."""
    out: List[Tuple[float, float]] = []
    for _, s, e, _ in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_seconds(summary: Dict[str, Any]) -> float:
    return sum(e - s for s, e in busy_intervals(summary["device_events"])) / 1e6


def idle_gaps(summary: Dict[str, Any]) -> List[Tuple[str, float]]:
    """The device's idle gaps inside the slice, longest first, each
    labelled with the innermost host span open at its middle ("host"
    where none is)."""
    lo, hi = summary["slice_range_us"]
    busy = busy_intervals(summary["device_events"])
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    out = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        open_spans = [(sp_e - sp_s, name) for name, sp_s, sp_e in summary["host_spans"]
                      if sp_s <= mid <= sp_e]
        out.append((min(open_spans)[1] if open_spans else "host", (e - s) / 1e6))
    return sorted(out, key=lambda g: -g[1])


def device_ops(summary: Dict[str, Any]) -> List[Tuple[str, float]]:
    """Device seconds by event name, largest first."""
    by: Dict[str, float] = {}
    for name, s, e, _ in summary["device_events"]:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])


def matching_seconds(summary: Dict[str, Any], needles: Tuple[str, ...]) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds one of
    ``needles``."""
    total, count = 0.0, 0
    for name, s, e, kind in summary["device_events"]:
        if kind == "kernel" and any(n in name for n in needles):
            total += (e - s) / 1e6
            count += 1
    return total, count


def breakdown(summary: Dict[str, Any], top: int = 10) -> Dict[str, List[List[Any]]]:
    return {"device_ops": [[n[:120], s] for n, s in device_ops(summary)[:top]],
            "idle_gaps": [[n, s] for n, s in idle_gaps(summary)[:top]]}
