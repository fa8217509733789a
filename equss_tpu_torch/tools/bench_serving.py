"""Serving-artifact A/B: the symbolic-batch and the pinned-batch
``torch.export`` artifacts against the live predictor.

    python3 -m equss_tpu_torch.tools.bench_serving [--batch 128] [--res 224]
        [--config X.yaml] [--override a.b=c] [--device cpu]

The port's counterpart of ``tools/bench_serving.py``.  The trainer of the
config (``configs/pqgo_cocostuff27.yaml`` by default; seeded random
weights) is exported by ``serve.export_predictor`` with
``symbolic_batch="auto"`` and ``"off"`` for (``--batch``, ``--res``,
``--res``, 3) input, each artifact written with ``save_predictor`` and
read back with ``load_predictor``.  On the card both artifacts carry the
kernels: the quantizer's ``auto`` route takes the kernel on CUDA for any
batch, so the graph of each calls ``equss::attention_qkv`` and
``equss::pq_assign`` (on the CPU a symbolic trace takes the plain PQ
route, as the JAX package's does).  For the live predictor and each
artifact: img/s and ms per call (3 warm-up calls, then the best of 3
windows of 12 calls on one device-resident input, each window ending in
a host read of the predictions), the kernel launches of one request, the
graph's ``equss::`` ops and the share of pixels equal to the live
predictor's.  Prints one line per predictor and one JSON line with all.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from equss_tpu_torch.device import synchronize
from equss_tpu_torch.tools.common import (
    add_config_args,
    add_device_arg,
    device_name,
    load_config,
)


def time_predict(predict, img: torch.Tensor, batch: int, *, windows: int = 3,
                 iters: int = 12) -> dict:
    for _ in range(3):                        # warm-up
        int(predict(img)["cluster_preds"].sum())
    dts = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = predict(img)
        int(out["cluster_preds"].sum())       # waits for the queued calls
        dts.append(time.perf_counter() - t0)
    best = min(dts)
    return {"img_per_sec": batch * iters / best, "ms_per_call": 1e3 * best / iters}


def request_launches(predict, img: torch.Tensor, dev: torch.device) -> dict:
    """The kernel launches of one request."""
    from equss_tpu_torch import launch_counts

    before = launch_counts()
    predict(img)
    synchronize(dev)
    return {k: v - before[k] for k, v in launch_counts().items()}


def graph_ops(exported: torch.export.ExportedProgram) -> dict:
    """How often the graph calls each ``equss::`` op."""
    ops: dict = {}
    for n in exported.graph.nodes:
        target = str(n.target)
        if n.op == "call_function" and target.startswith("equss."):
            op = target.split(".")[1]
            ops[op] = ops.get(op, 0) + 1
    return ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--res", type=int, default=224)
    add_config_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from equss_tpu_torch import resolve_device, serve
    from equss_tpu_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    trainer = Trainer(load_config(args.config, args.override), device=dev)
    live = serve.build_predict_fn(trainer)
    img = torch.from_numpy(np.random.RandomState(1).rand(
        args.batch, args.res, args.res, 3).astype(np.float32)).to(dev)
    ref = live(img)

    results = {"live": dict(time_predict(live, img, args.batch),
                            launches_per_request=request_launches(live, img, dev))}
    print(f"  live: {results['live']}", flush=True)
    with tempfile.TemporaryDirectory(prefix="equss_bench_serving_") as tmp:
        for mode in ("auto", "off"):
            t0 = time.perf_counter()
            exported = serve.export_predictor(trainer, (args.res, args.res),
                                              batch_size=args.batch, symbolic_batch=mode)
            path = serve.save_predictor(exported, os.path.join(tmp, f"{mode}.pt2"))
            export_s = time.perf_counter() - t0
            predict = serve.load_predictor(path)
            out = predict(img)
            placeholder = [n for n in exported.graph.nodes if n.op == "placeholder"][-1]
            row = dict(time_predict(predict, img, args.batch),
                       launches_per_request=request_launches(predict, img, dev),
                       graph_ops=graph_ops(exported), export_seconds=export_s,
                       input_shape=str(tuple(placeholder.meta["val"].shape)),
                       pixel_agreement_vs_live={
                           k: (out[k] == ref[k]).float().mean().item() for k in ref})
            results[f"symbolic_batch={mode}"] = row
            print(f"  symbolic_batch={mode}: {row}", flush=True)
    out = {"tool": "bench_serving", "device": device_name(dev), "batch": args.batch,
           "res": args.res, **results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
