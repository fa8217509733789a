"""The ``segment`` driver: one closed-loop client segmenting a collection
through the port's live predictor (``serve.build_predict_fn``).

A request is one host batch of uint8 images: copied to the card, the
predictor's forward, its ``cluster_preds`` copied back.  Its latency
runs from the start of the copy in to the map on the host.  The window
runs requests back to back until ``seconds`` have passed; its length
runs to the end of the last request.  A seeded reservoir keeps
``check_requests`` of the window's requests (both maps: the cluster map
from the host, the linear map where the predictor left it), which the
reference judges once the window has closed.
"""
from __future__ import annotations

import dataclasses
import gc
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from perfbench import check, trace, traffic
from perfbench.reference import model as ref
from perfbench.reference import precision
from perfbench.weights import make_weights


@dataclasses.dataclass
class State:
    device: torch.device
    trainer: Any
    predict: Any
    pool: List[torch.Tensor]
    seed: int
    phases: Dict[str, float]


def setup(cell, seed: int, device: torch.device) -> State:
    from equss_tpu_torch.serve import build_predict_fn
    from equss_tpu_torch.train.trainer import Trainer

    t0 = time.time()
    trainer = Trainer(cell.config, device=device, seed=traffic.sub_seed(seed, "trainer"))
    t1 = time.time()
    trainer.load_state_dict(make_weights(cell.widths, cell.classes, seed, device))
    pool = traffic.segment_pool(cell.mix, seed, device)
    t2 = time.time()
    state = State(device, trainer, build_predict_fn(trainer), pool, seed, {})
    for img in state.pool[:2]:          # every shape of the window, kernels built
        _request(state, img, False)
    _sync(device)
    state.phases = {"trainer": t1 - t0, "weights_traffic": t2 - t1,
                    "warmup": time.time() - t2}
    return state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _request(state: State, img: torch.Tensor, traced: bool):
    with trace.span("request.copy_in", traced):
        x = img.to(state.device)
    with trace.span("request.predict", traced):
        out = state.predict(x)
    with trace.span("request.copy_out", traced):
        cluster = out["cluster_preds"].cpu()
    return cluster, out["linear_preds"]


def window(state: State, cell, seconds: float, traced: bool) -> Dict[str, Any]:
    mix = cell.mix
    order = traffic.order(state.seed, mix["pool"], 1 << 16)
    keep = random.Random(traffic.sub_seed(state.seed, "sample"))
    k = int(mix["check_requests"])
    kept: List[Dict[str, Any]] = []
    lat: List[float] = []
    n = 0

    def one() -> None:
        nonlocal n
        i = order[n % len(order)]
        t0 = time.perf_counter()
        cluster, linear = _request(state, state.pool[i], traced)
        lat.append(time.perf_counter() - t0)
        # reservoir sampling: every request of the window equally likely
        sample = {"pool": i, "cluster": cluster, "linear": linear}
        if len(kept) < k:
            kept.append(sample)
        else:
            j = keep.randrange(n + 1)
            if j < k:
                kept[j] = sample
        n += 1

    summary: Optional[Dict[str, Any]] = None
    start = time.perf_counter()
    if traced:
        def body():
            for _ in range(int(mix["trace_requests"])):
                one()
            return {"units": int(mix["trace_requests"]),
                    "images": int(mix["trace_requests"]) * mix["batch"]}
        summary = trace.profile_slice(body, state.device)
    rest_n, rest_t0 = n, time.perf_counter()
    while time.perf_counter() - start < seconds:
        one()
    end = time.perf_counter()
    if summary is not None:
        summary["rest"] = {"units": n - rest_n, "images": (n - rest_n) * mix["batch"],
                           "seconds": end - rest_t0}
    return {"attempted": n, "failed": 0, "seconds": end - start,
            "images": n * mix["batch"], "latencies": lat, "kept": kept,
            "summary": summary}


def release(state: State) -> None:
    state.trainer = state.predict = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def end_to_end(win: Dict[str, Any]) -> Dict[str, float]:
    lat_ms = 1e3 * np.asarray(win["latencies"])
    return {"segment_img_s": win["images"] / win["seconds"],
            "segment_p95_ms": float(np.percentile(lat_ms, 95))}


def compare(cell, seed: int, device: torch.device, pool: List[torch.Tensor],
            kept: List[Dict[str, Any]], precs: Dict[str, str]) -> Dict[str, float]:
    """For each probe, the widest over the kept requests of the mean
    shortfall of the reference's score at the predicted class below its
    best score (``<probe>_shortfall``)."""
    W = make_weights(cell.widths, cell.classes, seed, device)
    worst = {"cluster_shortfall": 0.0, "linear_shortfall": 0.0}
    with precision.tf32_off():
        for r in kept:
            got = {p: r[p].to(device).long() for p in ("cluster", "linear")}
            short = {p: 0.0 for p in got}
            for s, scores in ref.logits(W, pool[r["pool"]].to(device), cell.widths, precs):
                for p, sc in scores.items():
                    at = sc.gather(-1, got[p][s:s + sc.shape[0], ..., None])[..., 0]
                    short[p] += float((sc.max(-1).values - at).sum())
            for p in got:
                worst[f"{p}_shortfall"] = max(worst[f"{p}_shortfall"],
                                              short[p] / got[p].numel())
    return worst


def check_numbers(cell, seed: int, device: torch.device, state: State,
                  win: Dict[str, Any]) -> List[check.Number]:
    if not win["kept"]:
        return [("sampled_requests", 0.0, -1.0)]
    worst = compare(cell, seed, device, state.pool, win["kept"],
                    precision.REFERENCE)
    return [(name, value, cell.limits[name]) for name, value in worst.items()]
