"""The ``train`` driver: ``Trainer.train_step`` on host batches, as the
epoch loop calls it.

Set-up builds one trainer from the seed's weights and drives it through
its first ``checked_steps`` steps, on that many distinct batches of the
pool, through the same call the window makes.  It keeps each step's loss,
the first gradient of every leaf as its optimizer took it (Adam's first
moment after one step over 1 - beta1) and every leaf after the checked
steps.  After ``warmup_steps`` more, the same trainer runs the window:
steps back to back on the pool in a seeded order until ``seconds`` have
passed, the last step synchronised.  Each step copies its host batch in
and reads its metrics back, as ``Trainer.train_step`` does.

One step of the window is checked as well: the first that starts after a
seeded share of the window, between a tenth and nine tenths.  Before it
the driver copies the trainable leaves, each leaf's Adam moments and step
count and the generator's state (a few MB, on the device); after it the
leaves and the first moments again, whose difference gives the gradient
each optimizer took, (m_after - beta1 m_before) / (1 - beta1).  The
reference follows that one step from the copy: it can follow a step deep
in the window only from the program's own state, and the first steps,
followed from the seed's weights, check the start by themselves.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from perfbench import check, trace, traffic
from perfbench.reference import precision
from perfbench.reference.train import LEAVES, run_steps
from perfbench.weights import make_weights

BETA1 = 0.9

#: the loss terms the trainer reports, as ``<term>-loss``
TERMS = ("stego", "vq", "linear", "cluster")

#: the trainer's optimizers and the prefix of their parameters' names
OPTIMIZERS = {"model": "", "cluster": "probes.cluster_probe.", "linear": "probes.linear_probe."}

#: a run's readings over steps, the program's and the reference's alike:
#: ``losses`` and ``terms`` of each step, ``grads`` (each leaf's gradient
#: of the first step as its optimizer took it), ``after`` (each leaf after
#: the last step)
Readings = Dict[str, Any]


@dataclasses.dataclass
class State:
    device: torch.device
    trainer: Any
    pool: List[Dict[str, torch.Tensor]]
    seed: int
    dropout_seed: int
    start: Readings
    skipped: int
    phases: Dict[str, float]
    #: the window's checked step: ``index`` (among the window's steps),
    #: ``pool`` (its batch), ``before`` (the copy before it), ``readings``,
    #: ``skipped``
    window_step: Optional[Dict[str, Any]] = None


def snapshot(trainer) -> Dict[str, Any]:
    """The trainable leaves (f32 copies), each leaf's Adam moments and step
    count (nought where its optimizer holds no state for it yet) and the
    generator's state."""
    ts = trainer.train_state()
    sd = trainer.state_dict()
    params = {k: sd[k].detach().float().clone() for k in LEAVES}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    t = {k: 0 for k in LEAVES}
    for name, prefix in OPTIMIZERS.items():
        for leaf, st in ts["opt"][name]["state"].items():
            k = prefix + leaf
            if k in m and "exp_avg" in st:
                m[k] = st["exp_avg"].detach().float().clone()
                v[k] = st["exp_avg_sq"].detach().float().clone()
                t[k] = int(st["step"])
    return {"params": params, "m": m, "v": v, "t": t, "generator": ts["generator"]}


def taken(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient as its optimizer took it in the step between
    two snapshots, from Adam's first moments."""
    return {k: (after["m"][k] - BETA1 * before["m"][k]) / (1.0 - BETA1) for k in LEAVES}


def _step(trainer, batch) -> Dict[str, Any]:
    r = trainer.train_step(batch)
    return {"loss": r["loss"], "terms": {k: r[f"{k}-loss"] for k in TERMS},
            "skipped": int(r["skipped"])}


def setup(cell, seed: int, device: torch.device) -> State:
    from equss_tpu_torch.train.trainer import Trainer

    mix = cell.mix
    dropout_seed = traffic.sub_seed(seed, "trainer")
    t0 = time.time()
    trainer = Trainer(cell.config, device=device, seed=dropout_seed)
    t1 = time.time()
    trainer.load_state_dict(make_weights(cell.widths, cell.classes, seed, device))
    pool = traffic.train_pool(mix, seed, cell.classes, cell.config["loss"].get("stego"), device)
    t2 = time.time()
    checked = int(mix["checked_steps"])
    if checked > len(pool):
        raise ValueError("the checked steps need distinct batches")
    s0 = snapshot(trainer)
    steps = []
    for i in range(checked):
        steps.append(_step(trainer, pool[i]))
        if i == 0:
            s1 = snapshot(trainer)
    start = {"losses": [s["loss"] for s in steps], "terms": [s["terms"] for s in steps],
             "grads": taken(s0, s1), "after": snapshot(trainer)["params"]}
    for j in range(int(mix["warmup_steps"])):
        trainer.train_step(pool[(checked + j) % len(pool)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases = {"trainer": t1 - t0, "weights_traffic": t2 - t1, "steps": time.time() - t2}
    return State(device, trainer, pool, seed, dropout_seed, start,
                 sum(s["skipped"] for s in steps), phases)


def window_step_share(seed: int) -> float:
    """Where in the window the checked step starts, from the seed."""
    rng = np.random.default_rng(traffic.sub_seed(seed, "window_step"))
    return 0.1 + 0.8 * float(rng.random())


def window(state: State, cell, seconds: float, traced: bool) -> Dict[str, Any]:
    mix = cell.mix
    order = traffic.order(state.seed, len(state.pool), 1 << 16)
    n, failed = 0, 0

    def one() -> Dict[str, Any]:
        nonlocal n, failed
        with trace.span("step.train_step", traced):
            r = _step(state.trainer, state.pool[order[n % len(order)]])
        failed += r["skipped"]
        n += 1
        return r

    def checked() -> None:
        i = order[n % len(order)]
        before = snapshot(state.trainer)
        r = one()
        after = snapshot(state.trainer)
        state.window_step = {
            "index": n - 1, "pool": i, "before": before, "skipped": r["skipped"],
            "readings": {"losses": [r["loss"]], "terms": [r["terms"]],
                         "grads": taken(before, after), "after": after["params"]}}

    summary: Optional[Dict[str, Any]] = None
    start = time.perf_counter()
    check_at = start + window_step_share(state.seed) * seconds
    if traced:
        def body():
            for _ in range(int(mix["trace_steps"])):
                one()
            return {"units": int(mix["trace_steps"]),
                    "images": int(mix["trace_steps"]) * mix["batch"]}
        summary = trace.profile_slice(body, state.device)
    rest_n, rest_t0 = n, time.perf_counter()
    # the checked step runs even where the window closes first
    while time.perf_counter() - start < seconds or state.window_step is None:
        if state.window_step is None and time.perf_counter() >= check_at:
            checked()
        else:
            one()
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    end = time.perf_counter()
    if summary is not None:
        summary["rest"] = {"units": n - rest_n, "images": (n - rest_n) * mix["batch"],
                           "seconds": end - rest_t0}
    return {"attempted": n, "failed": failed, "seconds": end - start, "steps": n,
            "summary": summary}


def release(state: State) -> None:
    state.trainer = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def end_to_end(win: Dict[str, Any]) -> Dict[str, float]:
    return {"train_step_ms": 1e3 * win["seconds"] / max(win["steps"], 1)}


def program_readings(state: State) -> Dict[str, Readings]:
    return {"start": state.start, "window": state.window_step["readings"]}


def reference_readings(cell, seed: int, device: torch.device, state: State,
                       precs: Dict[str, str]) -> Dict[str, Any]:
    """The reference at ``precs`` over the checked steps: the first steps
    from the seed's weights, the window's step from the copy before it;
    with the leaves each starts from (``before``, ``window_before``)."""
    W = make_weights(cell.widths, cell.classes, seed, device)
    batches = [{k: v.to(device) for k, v in state.pool[i].items()}
               for i in range(int(cell.mix["checked_steps"]))]
    ws = state.window_step
    win_batch = {k: v.to(device) for k, v in state.pool[ws["pool"]].items()}
    with precision.tf32_off():
        first = run_steps(W, cell.config, cell.widths, batches, state.dropout_seed, precs)
        win = run_steps(W, cell.config, cell.widths, [win_batch], state.dropout_seed, precs,
                        start=ws["before"])
    return {"before": {k: W[k].float() for k in LEAVES}, "start": first,
            "window_before": ws["before"]["params"], "window": win}


def _numbers(prog: Readings, ref: Readings, before: Dict[str, torch.Tensor], prefix: str,
             details: Optional[Dict[str, Any]]) -> Dict[str, float]:
    leaves = check.counted_leaves(ref["grads"])
    change = {k: prog["after"][k] - before[k] for k in LEAVES}
    ref_change = {k: ref["after"][k] - before[k] for k in LEAVES}
    if details is not None:
        details[prefix + "loss_steps"] = [check.loss_gap([p], [q])
                                          for p, q in zip(prog["losses"], ref["losses"])]
        details[prefix + "term_steps"] = [{k: check.loss_gap([t[k]], [u[k]]) for k in TERMS}
                                          for t, u in zip(prog["terms"], ref["terms"])]
        details[prefix + "grad_leaves"] = check.leaf_gaps(prog["grads"], ref["grads"], leaves)
        details[prefix + "change_leaves"] = check.leaf_gaps(change, ref_change, leaves)
        details[prefix + "ref_change_norms"] = {k: float(ref_change[k].norm()) for k in leaves}
        details[prefix + "counted"] = len(leaves)
    return {prefix + "loss_gap": check.loss_gap(prog["losses"], ref["losses"]),
            prefix + "grad_gap_median": check.median_leaf_gap(prog["grads"], ref["grads"],
                                                              leaves),
            prefix + "change_gap_median": check.median_leaf_gap(change, ref_change, leaves),
            prefix + "change_gap_worst": check.worst_leaf_gap(change, ref_change, leaves)}


def compare(ref: Dict[str, Any], prog: Dict[str, Readings],
            details: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """The gaps of ``prog``'s readings (``program_readings``, or another
    reference's in the program's place) against ``ref``
    (``reference_readings``): the first steps' numbers, then the window
    step's under ``window_``.  ``details``, where given, receives the gaps
    step by step, term by term and leaf by leaf."""
    out = _numbers(prog["start"], ref["start"], ref["before"], "", details)
    out.update(_numbers(prog["window"], ref["window"], ref["window_before"], "window_",
                        details))
    return out


def check_numbers(cell, seed: int, device: torch.device, state: State,
                  win: Dict[str, Any]) -> List[check.Number]:
    ref = reference_readings(cell, seed, device, state, precision.REFERENCE)
    nums = compare(ref, program_readings(state))
    out = [(name, value, cell.limits[name]) for name, value in nums.items()
           if cell.limits[name] is not None]
    skipped = state.skipped + state.window_step["skipped"]
    return out + [("skipped_checked_steps", float(skipped), 0.0)]
