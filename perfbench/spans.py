"""A cell's traced slice put down to the program's spans, for study: no
cell runs this, and no result line reads it.

    python3 -m perfbench.spans --workload <name> --seed <n> [--pairs 3]

The program marks its layers with ``equss.*`` ranges while the profiler
records (``equss_tpu_torch/core/trace.py``); ``trace.profile_slice``
keeps them apart from the benchmark's spans.  This sets the cell up as a
run does, serves one slice unprofiled, then profiles one slice as a
traced run does, and puts (``attribute``, the rule the per-layer readers
read by, ``readers.by_span``)

* each device event (kernel, copy, memset) down to the innermost span
  open when its launching runtime call started, linked by the profiler's
  correlation id.  Autograd launches the backward's kernels from its own
  thread while the step's thread waits inside ``equss.backward``, so the
  launch's time, not the thread's range tree, decides;
* each idle gap of the device to the innermost span open at its middle;
* each blocking runtime call (``cuda{Stream,Device,Event}Synchronize``)
  to the span it started in.

Then ``--pairs`` times the harness's own traced slice (``profile_slice``)
with the program's spans on, off, off, on, for what they cost: its wall
ms and idle share.  Prints one JSON line, per request or step.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from perfbench import trace

Range = Tuple[str, float, float]


def innermost(ranges: List[Range], t: float) -> str:
    """The shortest of ``ranges`` open at ``t``; "host" where none is."""
    open_ = [(e - s, n) for n, s, e in ranges if s <= t <= e]
    return min(open_)[1] if open_ else "host"


def attribute(ranges: List[Range], device: List[Tuple[str, float, float, Optional[float]]],
              blocking: List[Tuple[str, float]], slice_range: Tuple[float, float],
              units: int) -> Dict[str, Any]:
    """Per unit: device ms by the span its launch started in ("unlinked"
    where the launch was not seen), idle ms by the span open at the gap's
    middle with the ten longest gaps, blocking calls by span.  Times in
    µs; ``device`` holds (name, start, end, launch start or None)."""
    def add(d, k, v):
        d[k] = d.get(k, 0.0) + v

    work: Dict[str, float] = {}
    for _, s, e, at in device:
        add(work, "unlinked" if at is None else innermost(ranges, at), (e - s) / 1e3 / units)
    gaps = trace.idle_gaps({"slice_range_us": slice_range, "host_spans": ranges,
                            "device_events": [(n, s, e, "") for n, s, e, _ in device]})
    idle: Dict[str, float] = {}
    for name, seconds in gaps:
        add(idle, name, 1e3 * seconds / units)
    syncs: Dict[str, float] = {}
    for _, t in blocking:
        add(syncs, innermost(ranges, t), 1.0 / units)

    def ranked(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    lo, hi = slice_range
    return {"window_ms": (hi - lo) / 1e3 / units, "device_ms_by_span": ranked(work),
            "idle_ms_by_span": ranked(idle),
            "top_gaps_ms": [[n, 1e3 * seconds] for n, seconds in gaps[:10]],
            "blocking_calls_by_span": ranked(syncs)}


def profile(body: Callable[[], int], device: torch.device) -> Dict[str, Any]:
    """``body`` (which returns its units) under ``trace.profile_slice``,
    reduced by ``attribute``."""
    from perfbench import readers

    s = trace.profile_slice(lambda: {"units": body()}, device)
    out = readers.by_span(s)
    out["device_events"] = len(s["device_events"])
    out["linked"] = sum(1 for at in s["launch_us"] if at is not None)
    return out


def run(c, seed: int, device: torch.device, pairs: int) -> Dict[str, Any]:
    """Set cell ``c`` up, then ``profile`` one slice and time ``pairs``
    on/off pairs of the harness's traced slice."""
    from equss_tpu_torch.core import trace as program

    drv = importlib.import_module(f"perfbench.drivers.{c.mix['driver']}")
    state = drv.setup(c, seed, device)
    train = c.mix["driver"] == "train"
    units = int(c.mix["trace_steps" if train else "trace_requests"])
    served = [0]

    def body() -> int:
        for _ in range(units):
            i = served[0] % len(state.pool)
            served[0] += 1
            if train:
                with trace.span("step.train_step", True):
                    drv._step(state.trainer, state.pool[i])
            else:
                drv._request(state, state.pool[i], True)
        return units

    body()
    out = {"workload": c.name, "seed": seed, "units": units, **profile(body, device)}
    span = program.span
    cost: Dict[str, Dict[str, List[float]]] = {"on": {}, "off": {}}
    try:
        for _ in range(pairs):
            for mode in ("on", "off", "off", "on"):
                program.span = span if mode == "on" else (lambda _: program._NULL)
                s = trace.profile_slice(lambda: {"units": body()}, device)
                lo, hi = s["slice_range_us"]
                got = cost[mode]
                got.setdefault("slice_ms", []).append(1e3 * s["slice_s"] / units)
                if s["device_events"]:
                    got.setdefault("idle_pct", []).append(
                        100.0 * (1.0 - trace.busy_seconds(s) / ((hi - lo) / 1e6)))
    finally:
        program.span = span
    out["spans_on_off"] = {m: {k: {"median": statistics.median(v), "all": v}
                               for k, v in got.items()} for m, got in cost.items()}
    drv.release(state)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)

    from perfbench import cell as cells

    if not torch.cuda.is_available():
        print("perfbench.spans: needs a CUDA card", file=sys.stderr, flush=True)
        return 2
    from equss_tpu_torch.ops import _build

    _build.build()
    print(json.dumps(run(cells.load(args.workload), args.seed, torch.device("cuda", 0),
                         args.pairs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
