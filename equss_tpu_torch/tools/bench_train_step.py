"""Device-resident train-step benchmark: ms per step and img/s.

    python3 -m equss_tpu_torch.tools.bench_train_step [--batch 16]
        [--res 224] [--ln-stats f32|bf16] [--route stock|kernel]
        [--windows 3] [--iters 20] [--config X.yaml] [--override a.b=c]
        [--device cpu]

The port's counterpart of ``tools/bench_train_step.py``.  The config
(``configs/pqgo_cocostuff27.yaml`` by default) is read with
``dataloader.train.batch_size=--batch``, ``model.pretrained.ln_stats`` and
the ``--override``s; the trainer's weights come from the config's seed.
One synthetic batch (images, kNN positives and labels from a seeded numpy
generator) is placed on the device once.  Three warm-up steps, then
``--windows`` windows of ``--iters`` ``Trainer.train_step`` calls, each
window ending in ``torch.cuda.synchronize()`` (every step already reads
its metrics on the host for the non-finite check).

``--route`` picks the kernels of the step, as ``chip_smoke.py``'s two
train configurations do:

  stock   the config as it is: the attention kernel in the frozen
          backbone; the quantizer's ``use_pallas`` as the config says
          (``auto`` trains on the plain route, as in the JAX package,
          whose fused assignment is gated off in training);
  kernel  ``model.vq.use_pallas: 1`` (the PQ kernel under its
          hand-written backward, ``AssignSTE``) and ``fused_ln`` (every
          LayerNorm of the bf16 backbone on the LayerNorm kernels); an
          EQUSS model (``pqgo`` / ``vq``) only.

Prints one JSON line: ``ms_per_step_best`` and ``_median``,
``img_per_sec_best``, the knobs, the device and the kernel launches per
step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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


def make_trainer(cfg: dict, route: str, dev: torch.device):
    """The trainer of ``cfg`` on ``dev`` with the kernels of ``route``."""
    from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig
    from equss_tpu_torch.models.registry import resolve_model_name
    from equss_tpu_torch.train.trainer import Trainer

    if route == "stock":
        return Trainer(cfg, device=dev)
    if resolve_model_name(cfg) not in ("pqgo", "vq"):
        raise ValueError(f"--route kernel needs an EQUSS model (pqgo, vq), "
                         f"not {resolve_model_name(cfg)}")
    mcfg = dataclasses.replace(EQUSSConfig.from_config(cfg), fused_ln=True)
    return Trainer(cfg, device=dev, model=EQUSS(mcfg, device=dev, seed=cfg["seed"]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--ln-stats", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--route", default="stock", choices=["stock", "kernel"])
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    add_config_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from equss_tpu_torch import launch_counts, resolve_device

    dev = resolve_device(args.device)
    overrides = [f"model.pretrained.ln_stats={args.ln_stats}",
                 f"dataloader.train.batch_size={args.batch}"]
    if args.route == "kernel":
        overrides.append("model.vq.use_pallas=1")
    cfg = load_config(args.config, overrides + args.override)
    trainer = make_trainer(cfg, args.route, dev)

    rng = np.random.RandomState(0)
    shape = (args.batch, args.res, args.res, 3)
    batch = {
        "img": torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev),
        "img_pos": torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev),
        "label": torch.from_numpy(rng.randint(0, cfg["num_classes"],
                                              shape[:3]).astype(np.int32)).to(dev),
    }
    for _ in range(3):                       # warm-up: builds, caches, allocator
        trainer.train_step(batch)
    synchronize(dev)

    before = launch_counts()
    dts = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            trainer.train_step(batch)
        synchronize(dev)
        dts.append(time.perf_counter() - t0)
    steps = args.windows * args.iters
    best, med = min(dts), sorted(dts)[len(dts) // 2]
    out = {"tool": "bench_train_step", "device": device_name(dev),
           "ms_per_step_best": 1e3 * best / args.iters,
           "ms_per_step_median": 1e3 * med / args.iters,
           "img_per_sec_best": args.batch * args.iters / best,
           "ln_stats": args.ln_stats, "route": args.route,
           "batch": args.batch, "res": args.res, "windows": args.windows, "iters": args.iters,
           "launches_per_step": {k: (v - before[k]) / steps
                                 for k, v in launch_counts().items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
