"""A/B of the PQ assignment kernel against the library route.

    python3 -m equss_tpu_torch.tools.bench_pq_kernel [--n 51200 102400]
        [--exact] [--no-zq] [--M 64] [--K 256] [--d 16] [--device cpu]

The port's counterpart of ``tools/bench_pq_kernel.py``.  The whole
assignment (normalise -> distances -> first-minimum argmin -> codeword
gather) at the flagship shape (M = 64, K = 256, d = 16, l2) on
device-resident inputs from a seeded generator: the kernel
(``ops/pq_assign.py::pq_assign``, ``csrc/pq_assign.cu``; bf16 distances,
or with ``--exact`` f32) against normalise + ``torch.cdist`` + ``argmin``
+ gather in PyTorch calls (a yardstick the port never calls; with
``--no-zq`` it stops at the indices, while the kernel always writes z_q,
as every caller of the op wants it).  Each is timed with CUDA events over
10 back-to-back calls after one warm-up; the index agreement is the
share of (row, subspace) pairs where both pick the same codeword.  Prints
one line and one JSON line per n.
"""
from __future__ import annotations

import argparse
import json

import torch

from equss_tpu_torch.tools.common import add_device_arg, device_name, timed_ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[51200, 102400])
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--no-zq", action="store_true")
    ap.add_argument("--M", type=int, default=64)
    ap.add_argument("--K", type=int, default=256)
    ap.add_argument("--d", type=int, default=16)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from equss_tpu_torch import resolve_device
    from equss_tpu_torch.ops.pq_assign import kernel_body, normalize_vectors, pq_assign

    dev = resolve_device(args.device)
    M, K, d = args.M, args.K, args.d
    g = torch.Generator(device=dev).manual_seed(2)
    cb = torch.randn((M, K, d), generator=g, device=dev)
    cn = normalize_vectors(cb, "l2").contiguous()

    def library(z):
        zl = normalize_vectors(z, "l2").transpose(0, 1)               # (M, n, d)
        idx = torch.cdist(zl, cn).argmin(-1)                            # (M, n)
        if args.no_zq:
            return idx.T
        return idx.T, torch.gather(cb, 1, idx[..., None].expand(-1, -1, d))

    def kernel(z):
        return pq_assign(z, cn, cb, normalize="l2", exact=args.exact)

    mode = "exact" if args.exact else "bf16"
    rows = []
    print(f"M={M} K={K} d={d} mode={mode} want_zq={not args.no_zq} "
          f"body={kernel_body(d, K, args.exact)} on {device_name(dev)}", flush=True)
    for n in args.n:
        z = torch.randn((n, M, d), generator=g, device=dev)
        idx_l = library(z)
        idx_l = (idx_l if args.no_zq else idx_l[0]).to(torch.int32)
        idx_k = kernel(z)[0]
        agree = (idx_l == idx_k).float().mean().item()
        t_l = timed_ms(lambda: library(z), 10, dev, warmup=1)
        t_k = timed_ms(lambda: kernel(z), 10, dev, warmup=1)
        row = {"tool": "bench_pq_kernel", "device": device_name(dev), "n": n, "M": M, "K": K,
               "d": d, "mode": mode, "want_zq": not args.no_zq,
               "body": kernel_body(d, K, args.exact), "kernel_ms": t_k, "library_ms": t_l,
               "library_over_kernel": t_l / t_k, "index_agreement": agree}
        print(f"n={n:7d}: library {t_l:8.3f} ms   kernel {t_k:8.3f} ms   "
              f"({t_l / t_k:5.2f}x)   idx agree {100 * agree:.3f}%", flush=True)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del z
    return {"tool": "bench_pq_kernel", "rows": rows}


if __name__ == "__main__":
    main()
