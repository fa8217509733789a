"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start: imports, the CUDA context, the trainer, the
seed's weights, the traffic, the warm-up of the cell's own shapes) is
``setup_s``.  The window then runs ``--seconds``; with ``--trace 1`` its
first requests or steps run under the profiler and the result carries
the cell's per-layer metrics instead of its end-to-end ones.  After the
window the device's peak memory is read, the program's state is freed,
and the plain reference judges what the window produced.  The last line
on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), with
the compared numbers and their limits last under ``checks``; the same
numbers are the last lines on standard error.  Without a CUDA card, or
with fewer than the cell asks for, it prints no result and exits 2; if
JAX or the JAX package was loaded, it exits 3.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "equss_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``equss_tpu_torch`` is not ``equss_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def execute(c, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> Dict[str, Any]:
    """Everything of a run of cell ``c`` (``cell.load``) after the look for
    a card: set-up, window, the check.  Returns the result object (without
    printing it)."""
    import torch

    from perfbench import cell as cells
    from perfbench import check, trace

    drv = importlib.import_module(f"perfbench.drivers.{c.mix['driver']}")
    cuda = device.type == "cuda"
    if cuda:
        # every kernel of the port, whichever this cell runs, so that only a
        # checkout's first run compiles
        from equss_tpu_torch.ops import _build
        _build.build()
    t_setup = time.time()
    state = drv.setup(c, seed, device)
    setup_s = time.time() - t_start
    print("setup phases: " + json.dumps({"before_setup": t_setup - t_start, **state.phases}),
          file=sys.stderr, flush=True)
    win = drv.window(state, c, seconds, traced)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drv.release(state)
    numbers = drv.check_numbers(c, seed, device, state, win)

    dev: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": c.chips if cuda else 1,
        "memory_peak_bytes": int(peak),
        "power_limit": power_limit() if cuda else None,
    }
    extra: Dict[str, Any] = {}
    if traced:
        s = win["summary"]
        s.update(widths=c.widths, mix=c.mix, classes=c.classes)
        metrics = {}
        for m in c.per_layer:
            value = cells.reader(m["name"]).read(s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo, hi = s["slice_range_us"]
        dev.update(busy_s=trace.busy_seconds(s), window_s=(hi - lo) / 1e6)
        extra["breakdown"] = trace.breakdown(s)
    else:
        e2e = {**drv.end_to_end(win), "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c.end_to_end}
    result: Dict[str, Any] = {
        "correct": bool(check.verdict(numbers) and win["failed"] == 0),
        "attempted": int(win["attempted"]), "failed": int(win["failed"]),
        "metrics": metrics, "device": dev, **extra}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in numbers}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import cell as cells

    c = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {c.chips} CUDA card(s), found {have}",
              file=sys.stderr, flush=True)
        return 2
    result = execute(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr, flush=True)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
