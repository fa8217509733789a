"""Profile the serving forward and print its kernel-by-kernel budget.

    python3 -m equss_tpu_torch.tools.profile_forward [--model vit_small]
        [--batch 128] [--steps 5] [--top 40] [--res 224] [--device cpu]

The port's counterpart of ``tools/profile_forward.py``.  It builds the
serving model (ViT-S/8 or ViT-B/8 in bf16 with bf16 attention, hidden
1024, PQ 64 x 256 with l2 normalisation and the bf16 assignment; seeded
random weights), traces ``--steps`` forwards of a seeded uint8 request of
``--batch`` images with ``torch.profiler`` after two unprofiled ones, sums
the device time of each kernel and prints the ms per forward of each in
descending order, the device's busy share of the traced window and, last,
one JSON line with all of it.

``device_profile`` is the port's one profiler: ``chip_smoke.py`` calls it
for every profile it prints.  On the card it reads the kernels themselves
(the device-side events); with ``--device cpu`` there are none, and it
reads the CPU ops' own time instead, under ``cpu_*`` keys.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from equss_tpu_torch.device import synchronize
from equss_tpu_torch.tools.common import add_device_arg, device_name


def device_profile(fn, calls: int, pick=(), sequence: Optional[str] = None, top: int = 14,
                   device: torch.device = torch.device("cuda")) -> dict:
    """Device time by kernel and the device's busy share over ``calls``
    calls of ``fn`` (after two unprofiled ones), torch.profiler; the
    ``top`` kernels, and under ``picked`` every kernel whose name holds
    one of the strings ``pick``; with ``sequence``, under ``sequence`` the
    (name, ms) of every kernel whose name holds it, in the order they ran.
    On the CPU the ops' own CPU time, under ``cpu_ms`` and
    ``cpu_busy_share``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    for _ in range(2):
        fn()
    synchronize(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        synchronize(device)
        wall = time.perf_counter() - t0
    if cuda:
        # the kernels themselves (device-side events), not the ops that
        # launched them, which report the same time again
        kind, us = "device", lambda e: e.self_device_time_total   # noqa: E731
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and us(e) > 0]
    else:
        kind, us = "cpu", lambda e: e.self_cpu_time_total          # noqa: E731
        events = [e for e in prof.key_averages() if us(e) > 0]
    total = sum(us(e) for e in events)
    ranked = sorted(events, key=lambda e: -us(e))
    row = lambda e: {"name": e.key[:80], "ms": us(e) / 1e3,  # noqa: E731
                     "calls": e.count, "ms_per_call": us(e) / 1e3 / e.count}
    out = {"calls": calls, "wall_ms": 1e3 * wall, f"{kind}_ms": total / 1e3,
           f"{kind}_busy_share": total / 1e3 / (1e3 * wall),
           "kernel_launches": sum(e.count for e in events),
           "top": [row(e) for e in ranked[:top]],
           "picked": [row(e) for e in events if any(s in e.key for s in pick)]}
    if sequence is not None:
        ran = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and sequence in e.name),
                     key=lambda e: e.time_range.start)
        out["sequence"] = [(e.name[:80], e.time_range.elapsed_us() / 1e3) for e in ran]
    return out


def serving_config(model_type: str = "vit_small", precision: str = "bf16"):
    """``bench.py``'s serving preset: ``model_type`` /8 in bf16 with
    attn_bf16, hidden 1024, PQ 64 x 256 with l2 normalisation and the
    ``precision`` assignment."""
    from equss_tpu_torch import EQUSSConfig, PQConfig

    return EQUSSConfig(
        model_type=model_type, patch_size=8, hidden_dim=1024,
        backbone_dtype=torch.bfloat16, attn_bf16=True,
        pq=PQConfig(num_pq=64, num_codebook=256, embed_dim=1024,
                    vq_type="param", normalize="l2", assign_precision=precision))


def request(batch: int, res: int = 224, seed: int = 3) -> torch.Tensor:
    """A seeded raw uint8 RGB request of ``batch`` images, on the host."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (batch, res, res, 3), generator=g, dtype=torch.uint8)


def profile_serving(model, batch: int, steps: int, *, res: int = 224, seed: int = 3,
                    pick=(), top: int = 14) -> dict:
    """``device_profile`` of ``steps`` forwards of ``model`` on one seeded
    request of ``batch`` images, copied to the model's device and
    normalised once."""
    from equss_tpu_torch.data.transforms import normalize_images

    img = normalize_images(request(batch, res, seed).to(model.device))
    return device_profile(lambda: model(img), steps, pick=pick, top=top, device=model.device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vit_small")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--res", type=int, default=224)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from equss_tpu_torch import EQUSS, resolve_device

    dev = resolve_device(args.device)
    model = EQUSS(serving_config(args.model), device=dev, seed=0)
    prof = profile_serving(model, args.batch, args.steps, res=args.res, top=args.top)
    kind = "device" if dev.type == "cuda" else "cpu"
    per_step = prof[f"{kind}_ms"] / args.steps
    print(f"{kind} total: {per_step:8.3f} ms/step   (batch {args.batch}, {args.model}, "
          f"{args.res}^2, busy {100 * prof[f'{kind}_busy_share']:.1f}%)", flush=True)
    for r in prof["top"]:
        print(f"{r['ms'] / args.steps:8.3f} ms  {r['calls'] / args.steps:6.1f}x  "
              f"{r['name']}", flush=True)
    out = {"tool": "profile_forward", "device": device_name(dev), "model": args.model,
           "batch": args.batch, "res": args.res, "steps": args.steps,
           f"{kind}_ms_per_step": per_step, f"{kind}_busy_share": prof[f"{kind}_busy_share"],
           "wall_ms_per_step": prof["wall_ms"] / args.steps,
           "launches_per_step": prof["kernel_launches"] / args.steps,
           "kernels": [{"name": r["name"], "ms_per_step": r["ms"] / args.steps,
                        "calls_per_step": r["calls"] / args.steps} for r in prof["top"]]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
