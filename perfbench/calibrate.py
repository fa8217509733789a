"""The readings the limits of ``limits/<workload>.json`` are set from.

    python3 -m perfbench.calibrate --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 3] [--fault-seconds 2]

For each seed, in one process: a run of the cell as ``perfbench.run``
makes it (set-up, a window, the comparison with the reference): the
program's readings.  For each control seed also the control's: the
reference computed one step below the configuration's stated precisions
(``reference/precision.py``) in the program's place, against the
reference; and for a train cell the readings of each fault of
``faults.TRAIN``, planted in the program for a whole run of
``--fault-seconds``.  One JSON line per seed; ``limits/readings/``
keeps the lines the limits were set from.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import importlib
import json
import time

import torch

from perfbench import cell as cells
from perfbench import faults
from perfbench.reference import precision


def readings(c, drv, seed: int, seconds: float, device, control: bool,
             fault_seconds: float = 2.0):
    t0 = time.time()
    state = drv.setup(c, seed, device)
    win = drv.window(state, c, seconds, False)
    drv.release(state)
    out = {"attempted": win["attempted"], "failed": win["failed"]}
    if c.mix["driver"] == "train":
        from perfbench.drivers import train

        ref = train.reference_readings(c, seed, device, state, precision.REFERENCE)
        out["program"] = _train_numbers(ref, train.program_readings(state))
        out["program"]["skipped"] = state.skipped + state.window_step["skipped"]
        out["window_step"] = state.window_step["index"]
        if control:
            ctl = train.reference_readings(c, seed, device, state, precision.control(c.config))
            out["control"] = _train_numbers(ref, ctl)
            for name in faults.TRAIN:
                out["fault." + name] = _train_fault(c, drv, seed, device, name, fault_seconds)
    else:
        from perfbench.drivers import segment

        out["program"] = segment.compare(c, seed, device, state.pool, win["kept"],
                                         precision.REFERENCE)
        if control:
            out["control"] = _segment_control(c, seed, device, state, win,
                                              precision.control(c.config))
    out["seconds"] = time.time() - t0
    return out


def _train_numbers(ref, prog):
    from perfbench.drivers import train

    details = {}
    nums = train.compare(ref, prog, details)
    nums["details"] = details
    return nums


def _train_fault(c, drv, seed, device, name, seconds):
    from perfbench.drivers import train

    with faults.planted(name):
        state = drv.setup(c, seed, device)
        drv.window(state, c, seconds, False)
        drv.release(state)
    ref = train.reference_readings(c, seed, device, state, precision.REFERENCE)
    return _train_numbers(ref, train.program_readings(state))


def _segment_control(c, seed, device, state, win, ctl):
    from perfbench.drivers import segment
    from perfbench.reference import model as ref
    from perfbench.weights import make_weights

    W = make_weights(c.widths, c.classes, seed, device)
    kept = []
    with precision.tf32_off():
        for r in win["kept"]:
            p = ref.predict(W, state.pool[r["pool"]].to(device), c.widths, ctl)
            kept.append({"pool": r["pool"], "cluster": p["cluster_preds"],
                         "linear": p["linear_preds"]})
    return segment.compare(c, seed, device, state.pool, kept, precision.REFERENCE)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault-seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    c = cells.load(args.workload)
    drv = importlib.import_module(f"perfbench.drivers.{c.mix['driver']}")
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for s in [int(x) for x in args.seeds.split(",")]:
        out = readings(c, drv, s, args.seconds, device, s in controls, args.fault_seconds)
        print(json.dumps({"workload": args.workload, "seed": s, **out}), flush=True)


if __name__ == "__main__":
    main()
