#!/usr/bin/env python3
"""Drive the PyTorch port of EQUSS (``equss_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing JSON lines on stdout:

1. device   the card, its power limit (nvidia-smi), TF32 matmul off;
2. build    nvcc builds every kernel of ``equss_tpu_torch/csrc`` into
            ``equss_tpu_torch/_build`` (full compiler log:
            ``equss_tpu_torch/_build/build.log``);
3. kernels  each kernel against its plain PyTorch version on the card at
            the main path's shapes and a few more, with its time, the
            plain version's, one PyTorch library call's (a yardstick the
            port never calls) and the bound the card's peak rates set;
4. main     the ViT-S/8 224^2 bf16 -> head -> PQ 64x256 forward on raw
            uint8 requests at b = 1, 8 and 128 with seeded weights: launch
            counts (12 attention and 1 PQ per forward), ms per batch and
            img/s; a second configuration with exact PQ at b = 8; and the
            card's output held stage by stage against the same model run
            on the CPU on a small input;
5. profile  device time by kernel and the device's busy share over two
            forwards at b = 1 and b = 128 (torch.profiler).

Then the ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``.  Any failed check exits non-zero without the ok line; without
CUDA it exits non-zero before doing anything.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import torch


# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12        # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12

FAILURES: list = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> bool:
    if not cond:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)
    return cond


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, flop_rate: float, nbytes: float):
    t_ops, t_bytes = flops / flop_rate, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulp(x: torch.Tensor) -> float:
    return 2.0 ** (math.floor(math.log2(x.abs().max().item())) - 7)


# ---------------------------------------------------------------- phases

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi.splitlines()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32})
    return kind


def phase_build() -> None:
    from equss_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = _build.build()
    seconds = time.perf_counter() - t0
    if log:
        with open(_build.BUILD_DIR / "build.log", "w") as f:
            for name, text in log.items():
                f.write(f"== {name}\n{text}\n")
    # ptxas -v: "Used N registers, ..." and "N bytes spill stores/loads"
    regs = {name: max(map(int, re.findall(r"Used (\d+) registers", text)), default=None)
            for name, text in log.items()}
    spills = {name: sum(map(int, re.findall(r"(\d+) bytes spill", text)))
              for name, text in log.items()}
    emit({"phase": "build", "seconds": seconds, "built": sorted(log),
          "max_registers": regs, "spill_bytes": spills})


def phase_attention(results: dict) -> None:
    import torch.nn.functional as F

    from equss_tpu_torch.ops.attention import attention_qkv, attention_qkv_reference

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # name, B, N, H, n_real
        ("vit_s_224", 128, 785, 6, 785),      # the main path's shape
        ("vit_s_224_padded", 128, 896, 6, 785),
        ("vit_b_224", 32, 785, 12, 785),
        ("vit_s_320", 32, 1601, 6, 1601),
    ]
    for name, B, N, H, n_real in cases:
        hd, C = 64, 64 * H
        scale = hd ** -0.5
        qkv = torch.randn((B, N, 3 * C), generator=g, device="cuda").to(torch.bfloat16)
        out = attention_qkv(qkv, H, scale, n_real)
        ref = attention_qkv_reference(qkv, H, scale, n_real)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ulp = bf16_ulp(ref.float())
        check(bool(torch.isfinite(out).all()) and err <= ulp,
              f"attention {name}: max abs err {err} > 1 bf16 ulp {ulp}")
        ms = cuda_ms(lambda: attention_qkv(qkv, H, scale, n_real), iters=10)
        plain = cuda_ms(lambda: attention_qkv_reference(qkv, H, scale, n_real), iters=3)
        q, k, v = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k[:, :, :n_real], v[:, :, :n_real], scale=scale), iters=10)
        bnd, by = bound_ms(4.0 * B * H * N * n_real * hd, PEAK_BF16_FLOPS,
                           2.0 * B * N * (3 * C + C))
        row = {"phase": "kernel", "kernel": "attention_qkv", "case": name,
               "shape": [B, N, 3 * C], "heads": H, "n_real": n_real,
               "max_abs_err": err, "tolerance": ulp,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": bnd, "bound_by": by}
        emit(row)
        results.setdefault("attention_qkv", row)
        del qkv, out, ref, q, k, v
        torch.cuda.empty_cache()


def phase_pq(results: dict) -> None:
    from equss_tpu_torch.ops.pq_assign import (
        normalize_vectors,
        pq_assign,
        pq_assign_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    M, K, d = 64, 256, 16
    n_bench = 128 * 28 * 28
    cases = [  # name, n, normalize, exact
        ("bench_fast_l2", n_bench, "l2", False),   # the main path's call
        ("bench_exact_l2", n_bench, "l2", True),
        ("z_norm_exact", 16384, "z_norm", True),
        ("z_trainable_fast", 16384, "z_trainable", False),
    ]
    for name, n, mode, exact in cases:
        z = 3.0 * torch.randn((n, M, d), generator=g, device="cuda")
        cb = torch.randn((M, K, d), generator=g, device="cuda")
        zm = zs = None
        if mode == "z_trainable":
            zm = 0.1 * torch.randn((M, d), generator=g, device="cuda")
            zs = torch.exp(0.1 * torch.randn((M, d), generator=g, device="cuda"))
            mu = cb.mean(1, keepdim=True)
            cn = (cb - mu) / (torch.sqrt(((cb - mu) ** 2).sum(1, keepdim=True) / (K - 1)) + 1e-5)
        else:
            cn = normalize_vectors(cb, mode).contiguous()
        kw = dict(normalize=mode, z_mean=zm, z_std=zs, exact=exact)
        idx, zn, zq = pq_assign(z, cn, cb, **kw)
        idx_r, zn_r, zq_r = pq_assign_reference(z, cn, cb, **kw)
        torch.cuda.synchronize()
        same = idx == idx_r
        agree = same.float().mean().item()
        zn_err = (zn - zn_r).abs().max().item()
        zq_err_same = (zq - zq_r).abs()[same].max().item()
        src = cb if exact else cb.to(torch.bfloat16).float()
        zq_own = torch.equal(zq, src[torch.arange(M, device="cuda"), idx.long()])
        need = 0.9999 if exact else 0.995
        check(agree >= need, f"pq {name}: index agreement {agree} < {need}")
        check(zq_err_same == 0.0 and zq_own,
              f"pq {name}: z_q not the codeword at its index (err {zq_err_same})")
        check(bool(((idx >= 0) & (idx < K)).all()), f"pq {name}: index out of range")
        ms = cuda_ms(lambda: pq_assign(z, cn, cb, **kw), iters=10)
        plain = cuda_ms(lambda: pq_assign_reference(z, cn, cb, **kw), iters=3)

        def library():
            zl = normalize_vectors(z, mode, zm, zs).transpose(0, 1)   # (M, n, d)
            i = torch.cdist(zl, cn).argmin(-1)                          # (M, n)
            return torch.gather(cb, 1, i[..., None].expand(-1, -1, d))

        lib = cuda_ms(library, iters=3)
        nbytes = 4.0 * (n * M * d + 2 * M * K * d + n * M + 2 * n * M * d
                        + (2 * M * d if zm is not None else 0))
        bnd, by = bound_ms(2.0 * n * M * K * d,
                           PEAK_F32_FLOPS if exact else PEAK_BF16_FLOPS, nbytes)
        row = {"phase": "kernel", "kernel": "pq_assign", "case": name,
               "n": n, "M": M, "K": K, "d": d, "normalize": mode, "exact": exact,
               "index_agreement": agree, "required": need,
               "max_abs_err": zn_err, "zq_err_where_equal": zq_err_same,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": bnd, "bound_by": by}
        emit(row)
        results.setdefault("pq_assign", row)
        del z, cb, cn, idx, zn, zq, idx_r, zn_r, zq_r
        torch.cuda.empty_cache()


def main_config(precision: str = "bf16"):
    """bench.py's preset: ViT-S/8 at 224^2 in bf16 with attn_bf16, hidden
    1024, PQ 64 x 256 with l2 normalisation."""
    from equss_tpu_torch import EQUSSConfig, PQConfig

    return EQUSSConfig(
        model_type="vit_small", patch_size=8, hidden_dim=1024,
        backbone_dtype=torch.bfloat16, attn_bf16=True,
        pq=PQConfig(num_pq=64, num_codebook=256, embed_dim=1024,
                    vq_type="param", normalize="l2", assign_precision=precision))


def requests(batch: int, count: int, seed: int):
    """``count`` raw uint8 RGB requests of ``batch`` 224^2 images, on the host."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (batch, 224, 224, 3), generator=g, dtype=torch.uint8)
            for _ in range(count)]


def serve(model, reqs):
    """Answer each request: copy to the card, normalise, forward; the
    host clock runs from the copy to the synchronised result."""
    from equss_tpu_torch.data.transforms import normalize_images

    outs, times = [], []
    for req in reqs:
        t0 = time.perf_counter()
        out = model(normalize_images(req.to("cuda")))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    return outs, times


def check_outputs(out, batch: int, K: int, what: str) -> None:
    check(tuple(out["indices"].shape) == (batch, 28, 28, 64)
          and tuple(out["z_q"].shape) == (batch, 28, 28, 1024), f"{what}: shapes")
    check(bool(torch.isfinite(out["z_q"]).all()) and bool(torch.isfinite(out["feat"]).all()),
          f"{what}: non-finite output")
    idx = out["indices"]
    check(bool(((idx >= 0) & (idx < K)).all()), f"{what}: index outside [0, K)")


def phase_main(results: dict):
    """Serve the main configuration and the exact one; returns the main
    model."""
    from equss_tpu_torch import EQUSS, launch_counts, reset_launch_counts

    cfg = main_config("bf16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = EQUSS(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    emit({"phase": "main_init", "seconds": time.perf_counter() - t0})
    depth = model.vit_cfg.depth

    plan = [(1, 2, 30), (8, 2, 30), (128, 2, 5)]     # batch, warm-up, timed
    reqs = {b: requests(b, w + n, seed=b) for b, w, n in plan}
    reset_launch_counts()
    forwards = 0
    for batch, warm, timed in plan:
        before = launch_counts()
        outs, times = serve(model, reqs[batch])
        forwards += warm + timed
        after = launch_counts()
        n_fwd = warm + timed
        check(after["attention_qkv"] - before["attention_qkv"] == depth * n_fwd
              and after["pq_assign"] - before["pq_assign"] == n_fwd,
              f"main b={batch}: launches {after} vs {before} for {n_fwd} forwards")
        for out in outs:
            check_outputs(out, batch, cfg.pq.num_codebook, f"main b={batch}")
        t = sorted(times[warm:])
        ms = 1e3 * sum(t) / len(t)
        emit({"phase": "main", "config": "bf16", "batch": batch, "forwards": n_fwd,
              "ms_per_batch_mean": ms, "ms_per_batch_min": 1e3 * t[0],
              "ms_per_batch_median": 1e3 * t[len(t) // 2],
              "img_per_s": batch * 1e3 / ms,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        del outs
    counts = launch_counts()
    check(counts["attention_qkv"] == depth * forwards and counts["pq_assign"] == forwards,
          f"main path launches {counts} for {forwards} forwards")
    check(all(v > 0 for v in counts.values()), f"a kernel never launched: {counts}")
    results["launches"] = counts
    emit({"phase": "main_launches", "forwards": forwards, **counts})

    # second configuration: exact PQ at b = 8
    model_x = EQUSS(main_config("exact"), device="cuda", seed=0)
    warm, timed = 2, 30
    reset_launch_counts()
    outs, times = serve(model_x, requests(8, warm + timed, seed=80))
    counts_x = launch_counts()
    check(counts_x == {"attention_qkv": depth * (warm + timed), "pq_assign": warm + timed},
          f"exact config launches {counts_x}")
    for out in outs:
        check_outputs(out, 8, cfg.pq.num_codebook, "exact b=8")
    t = sorted(times[warm:])
    emit({"phase": "main", "config": "exact", "batch": 8, "forwards": warm + timed,
          "ms_per_batch_mean": 1e3 * sum(t) / len(t),
          "ms_per_batch_median": 1e3 * t[len(t) // 2], "img_per_s": 8 * len(t) / sum(t),
          **{f"launches_{k}": v for k, v in counts_x.items()}})
    del model_x, outs

    phase_reference(model, cfg)
    return model


def phase_reference(model, cfg) -> None:
    """The card's forward against the same seeded model on the CPU (plain
    kernel versions), stage by stage, on 2 images:
    * dense features: bf16 through 12 layers, rounded in another order on
      each side: mean relative error <= 2e-2, max abs error <= 0.25;
    * head (f32) on the card's own features: max error <= 1e-4 relative;
    * PQ (bf16 fast mode) on the card's own code: >= 99.5% indices equal;
    * end to end: >= 95% indices equal."""
    from equss_tpu_torch import EQUSS
    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.ops.quantizer import pq_forward

    ref_cfg = dataclasses.replace(cfg, pq=dataclasses.replace(cfg.pq, use_pallas=True))
    ref = EQUSS(ref_cfg, device="cpu", seed=0)
    img = normalize_images(requests(2, 1, seed=7)[0])
    out_g = model(img.to("cuda"))
    with torch.no_grad():
        feat_c = ref.features(img)
        feat_g = out_g["feat"].cpu()
        code_c = ref.encode(feat_g)
        _, idx_c, _, _ = pq_forward(out_g["code"].cpu(), dict(ref.pq),
                                    ref.pq_state.as_dict(), ref_cfg.pq)
    end_c = ref(img)
    feat_rel = ((feat_g - feat_c).abs().mean() / feat_c.abs().mean()).item()
    feat_max = (feat_g - feat_c).abs().max().item()
    head_rel = ((out_g["code"].cpu() - code_c).abs().max() / code_c.abs().max()).item()
    pq_agree = (out_g["indices"].cpu() == idx_c).float().mean().item()
    e2e_agree = (out_g["indices"].cpu() == end_c["indices"]).float().mean().item()
    check(feat_rel <= 2e-2 and feat_max <= 0.25,
          f"reference: features rel {feat_rel} / max {feat_max}")
    check(head_rel <= 1e-4, f"reference: head rel err {head_rel}")
    check(pq_agree >= 0.995, f"reference: PQ index agreement {pq_agree}")
    check(e2e_agree >= 0.95, f"reference: end-to-end index agreement {e2e_agree}")
    emit({"phase": "reference_cpu", "batch": 2, "feat_mean_rel_err": feat_rel,
          "feat_max_abs_err": feat_max, "head_max_rel_err": head_rel,
          "pq_index_agreement": pq_agree, "end_to_end_index_agreement": e2e_agree})


def phase_profile(model) -> None:
    """Device time by kernel and the device's busy share over two
    forwards at b = 1 and at b = 128 (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from equss_tpu_torch.data.transforms import normalize_images

    for batch in (1, 128):
        img = normalize_images(requests(batch, 1, seed=3)[0].to("cuda"))
        for _ in range(2):
            model(img)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                model(img)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the kernels themselves (device-side events), not the ops that
        # launched them, which report the same time again
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        emit({"phase": "profile", "batch": batch, "forwards": 2, "wall_ms": 1e3 * wall,
              "device_ms": total / 1e3, "device_busy_share": total / 1e3 / (1e3 * wall),
              "kernel_launches": sum(e.count for e in events),
              "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                       "calls": e.count} for e in top]})


def main() -> int:
    kind = phase_device()
    phase_build()
    results: dict = {}
    phase_attention(results)
    phase_pq(results)
    phase_profile(phase_main(results))

    sources = {"attention_qkv": ("equss_tpu_torch/csrc/attention_qkv.cu",
                                 "equss_tpu/ops/attention.py:198"),
               "pq_assign": ("equss_tpu_torch/csrc/pq_assign.cu",
                             "equss_tpu/ops/pq_pallas.py:443")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": results["launches"][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
