"""Two builds of the PQ assignment kernel, side by side on one card.

    python3 -m equss_tpu_torch.tools.pq_ab OLD.cu [CASE_PATTERN]

``OLD.cu`` is an earlier version of ``csrc/pq_assign.cu`` with a
``pq_assign_launch`` C entry; a build that exports
``pq_assign_workspace_bytes`` gets its workspace, an older one is called
without.  Both sources are compiled with the port's nvcc flags (in
parallel, into ``_build/ab/``); each build's ptxas register and spill
lines are printed.  At every case of ``chip_smoke.py``'s PQ phase (serve
and train fast l2, serve exact l2, z_norm exact, z_trainable fast), at
K = 512, d = 8 and d = 32, at the narrow exact body's domain (the train,
valid and b = 8 serving calls, a ragged n, ``none`` and ``z_trainable``,
K = 512, d = 8 and 32, K at the top of the narrow domain at each d), and
at the wide body's cases in both modes
(the VQ baseline's valid and predictor calls, M = 1, K = 256, d = 1024;
unseg 1 x 2048 x 384, vae 1 x 1024 x 256 and new_vq 8 x 2048 x 64 at
n = 12 800), both builds run on the same input.  Each build is held to
the plain version (``pq_assign_reference``) with the kernel's bar:
>= 99.99% of indices equal in exact mode, >= 99.5% in fast mode, indices
in range, z_q the codeword at the build's own index bit for bit, z_norm
within 1e-6 + 1e-6 |z_norm| (f32 sums in another order);
``identical_indices`` says whether the two builds agree everywhere, and
in exact mode ``identical_outputs`` whether z_norm and z_q are bit-equal
too (the exact bodies promise both: a difference there fails the run).
Then old, new and the library call (normalise + ``torch.cdist`` +
``argmin`` + gather, a yardstick the port never calls) are timed in turns
(old, new, library, library, new, old, three times: medians of six) with
CUDA events over back-to-back launches; in fast mode also a second
yardstick, normalise + a bf16 ``torch.baddbmm`` of the distances +
``argmin`` + gather (``library_bf16``, its indices not held).  One launch
moves 39-1233 MB (the paths' own sizes), so z comes mostly from
device memory.
Exact rows also give the new build's share of the f32 operations bound
(2 n M K d at 67 TFLOP/s) and its time over the library call's.  With
``CASE_PATTERN`` (a regular expression, e.g. ``wide_.*exact``) only the
cases whose name it matches run.  Prints the
card's name and power limit, one JSON line per build and per case, and
exits non-zero if a build or a launch fails or a bar is missed.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from equss_tpu_torch.ops import _build
from equss_tpu_torch.ops.pq_assign import MODES, normalize_vectors, pq_assign_reference
from equss_tpu_torch.tools.attention_ab import _time_ms

CASES = (  # name, n, M, K, d, normalize, exact
    ("serve_fast_l2", 128 * 28 * 28, 64, 256, 16, "l2", False),
    ("train_fast_l2", 16 * 28 * 28, 64, 256, 16, "l2", False),
    ("serve_exact_l2", 128 * 28 * 28, 64, 256, 16, "l2", True),
    ("z_norm_exact", 16384, 64, 256, 16, "z_norm", True),
    ("z_trainable_fast", 16384, 64, 256, 16, "z_trainable", False),
    ("k512_fast_l2", 16384, 64, 512, 16, "l2", False),
    ("d8_fast_l2", 16384, 128, 256, 8, "l2", False),
    ("d32_fast_l2", 16384, 32, 256, 32, "l2", False),
    # the narrow exact body's domain: the paths' calls (train step b = 16,
    # valid step b = 8 at 320^2, serving b = 8), its other widths, K and
    # normalisations, a ragged last round of rows and K at the top of the
    # narrow domain ((8d + 4) K <= 232 448) at each width
    ("train_exact_l2", 16 * 28 * 28, 64, 256, 16, "l2", True),
    ("valid_exact_l2", 8 * 40 * 40, 64, 256, 16, "l2", True),
    ("serve8_exact_l2", 8 * 28 * 28, 64, 256, 16, "l2", True),
    ("ragged_exact_l2", 16 * 28 * 28 + 37, 64, 256, 16, "l2", True),
    ("none_exact", 16384, 64, 256, 16, "none", True),
    ("z_trainable_exact", 16384, 64, 256, 16, "z_trainable", True),
    ("k512_exact_l2", 16384, 64, 512, 16, "l2", True),
    ("d8_exact_l2", 16384, 128, 256, 8, "l2", True),
    ("d32_exact_l2", 16384, 32, 256, 32, "l2", True),
    ("k1760_exact_l2", 16384, 64, 1760, 16, "l2", True),
    ("d8_k3418_exact_l2", 16384, 16, 3418, 8, "l2", True),
    ("d32_k894_exact_l2", 16384, 32, 894, 32, "l2", True),
    *((f"wide_{name}_{'exact' if exact else 'fast'}", n, M, K, d, "none", exact)
      for name, n, M, K, d in (("vq_valid", 8 * 40 * 40, 1, 256, 1024),
                               ("vq_predictor", 128 * 28 * 28, 1, 256, 1024),
                               ("unseg", 8 * 40 * 40, 1, 2048, 384),
                               ("vae", 8 * 40 * 40, 1, 1024, 256),
                               ("new_vq", 8 * 40 * 40, 8, 2048, 64))
      for exact in (False, True)),
)
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12


def _compile(sources):
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"libpq_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        ptxas = [ln.strip() for ln in log.splitlines()
                 if re.search(r"registers|spill|entry function", ln)]
        spills = sum(map(int, re.findall(r"(\d+) bytes spill", log)))
        print(json.dumps({"build": name, "rc": proc.returncode, "spill_bytes": spills,
                          "max_registers": max(map(int, re.findall(r"Used (\d+) registers",
                                                                  log)), default=None),
                          "ptxas": ptxas}), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        fn = dll.pq_assign_launch
        fn.restype = ctypes.c_int
        ws = getattr(dll, "pq_assign_workspace_bytes", None)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p] * (1 if ws is None else 2)
        if ws is not None:
            ws.restype = ctypes.c_size_t
            ws.argtypes = [ctypes.c_int] * 4
        libs[name] = (fn, ws)
    return libs


def case_inputs(n, M, K, d, mode, g):
    """z (n, M, d), the normalised codebook, the raw one and, for
    z_trainable, (M, d) statistics, on the card from generator ``g``: the
    PQ inputs of this tool and of ``chip_smoke.py``."""
    z = 3.0 * torch.randn((n, M, d), generator=g, device="cuda")
    cb = torch.randn((M, K, d), generator=g, device="cuda")
    zm = zs = None
    if mode == "z_trainable":
        zm = 0.1 * torch.randn((M, d), generator=g, device="cuda")
        zs = torch.exp(0.1 * torch.randn((M, d), generator=g, device="cuda"))
        mu = cb.mean(1, keepdim=True)
        cn = (cb - mu) / (torch.sqrt(((cb - mu) ** 2).sum(1, keepdim=True) / (K - 1)) + 1e-5)
    else:
        cn = normalize_vectors(cb, mode)
    return z, cn.contiguous(), cb, zm, zs


def library_call(z, cn, cb, mode, zm=None, zs=None):
    """The same assignment in library calls (normalise, ``torch.cdist``,
    ``argmin``, gather): the yardstick, which the port never calls."""
    zl = normalize_vectors(z, mode, zm, zs).transpose(0, 1)        # (M, n, d)
    i = torch.cdist(zl, cn).argmin(-1)                               # (M, n)
    return torch.gather(cb, 1, i[..., None].expand(-1, -1, z.shape[-1]))


def library_bf16_call(z, cn, cb, mode, zm=None, zs=None):
    """The fast mode's time yardstick in library calls: normalise, the
    distances |c|^2 - 2 z.c as one bf16 ``torch.baddbmm`` (bf16 operands,
    f32 sums, bf16 result), ``argmin``, gather.  Its indices are not held
    (the bf16 result ties many distances)."""
    zl = normalize_vectors(z, mode, zm, zs).transpose(0, 1).to(torch.bfloat16)
    cnb = cn.to(torch.bfloat16)
    csq = (cn * cn).sum(-1, keepdim=True).transpose(1, 2).to(torch.bfloat16)   # (M, 1, K)
    i = torch.baddbmm(csq, zl, cnb.transpose(1, 2), alpha=-2.0).argmin(-1)    # (M, n)
    return torch.gather(cb, 1, i[..., None].expand(-1, -1, z.shape[-1]))


def main(argv) -> int:
    if len(argv) not in (1, 2) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = _compile({"old": Path(argv[0]).resolve(),
                     "new": _build.CSRC_DIR / "pq_assign.cu"})
    g = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for name, n, M, K, d, mode, exact in CASES:
        if len(argv) == 2 and not re.search(argv[1], name):
            continue
        z, cn, cb, zm, zs = case_inputs(n, M, K, d, mode, g)
        outs = {b: (torch.empty((n, M), dtype=torch.int32, device="cuda"),
                    torch.empty_like(z), torch.empty_like(z)) for b in libs}

        wss = {}
        for b, (_, ws) in libs.items():
            nbytes = ws(M, K, d, int(exact)) if ws is not None else 0
            wss[b] = (torch.empty(nbytes, dtype=torch.uint8, device="cuda")
                      if nbytes else None)

        def run(b):
            idx, zn, zq = outs[b]
            fn, ws = libs[b]
            extra = () if ws is None else \
                (None if wss[b] is None else wss[b].data_ptr(),)
            err = fn(z.data_ptr(), cn.data_ptr(), cb.data_ptr(),
                     None if zm is None else zm.data_ptr(),
                     None if zs is None else zs.data_ptr(),
                     idx.data_ptr(), zn.data_ptr(), zq.data_ptr(), n, M, K, d,
                     MODES.index(mode), int(exact), stream, *extra)
            if err:
                raise RuntimeError(f"{b} launch failed: CUDA error {err}")

        for b in libs:
            run(b)
        torch.cuda.synchronize()
        idx_r, zn_r, _ = pq_assign_reference(z, cn, cb, normalize=mode, z_mean=zm,
                                             z_std=zs, exact=exact)
        need = 0.9999 if exact else 0.995
        src = cb if exact else cb.to(torch.bfloat16).float()
        m = torch.arange(M, device="cuda")
        checks = {}
        for b, (idx, zn, zq) in outs.items():
            agree = (idx == idx_r).float().mean().item()
            in_range = bool(((idx >= 0) & (idx < K)).all())
            zq_own = in_range and torch.equal(zq, src[m, idx.long()])
            zn_err = (zn - zn_r).abs().max().item()
            zn_ok = bool(((zn - zn_r).abs() <= 1e-6 + 1e-6 * zn_r.abs()).all())
            passed = agree >= need and in_range and zq_own and zn_ok
            ok &= passed
            checks[b] = {"index_agreement": agree, "zq_codeword_at_own_index": zq_own,
                         "zn_max_abs_err": zn_err, "zn_within_1e-6": zn_ok,
                         "passed": passed}
        identical = torch.equal(outs["old"][0], outs["new"][0])
        extra = {}
        if exact:
            extra["identical_outputs"] = all(torch.equal(outs["old"][i], outs["new"][i])
                                             for i in (1, 2))
            ok &= identical and extra["identical_outputs"]
        del idx_r, zn_r

        fns = {"old": lambda: run("old"), "new": lambda: run("new"),
               "library": lambda: library_call(z, cn, cb, mode, zm, zs)}
        if not exact:
            fns["library_bf16"] = lambda: library_bf16_call(z, cn, cb, mode, zm, zs)
        order = list(fns)
        times = {b: [] for b in order}
        for _ in range(3):
            for b in order + order[::-1]:
                times[b].append(_time_ms(fns[b], iters=10))
        nbytes = 4.0 * (3 * n * M * d + 2 * M * K * d + n * M
                        + (2 * M * d if zm is not None else 0))
        flops = 2.0 * n * M * K * d
        t_bytes, t_ops = nbytes / PEAK_BYTES, flops / (PEAK_F32_FLOPS if exact
                                                       else PEAK_BF16_FLOPS)
        med = {b: statistics.median(v) for b, v in times.items()}
        print(json.dumps({
            "case": name, "n": n, "M": M, "K": K, "d": d, "normalize": mode,
            "exact": exact, "required_agreement": need, "checks": checks,
            "identical_indices": identical, "median_ms": med,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound_new": 1e3 * max(t_bytes, t_ops) / med["new"],
            "new_over_old": med["new"] / med["old"],
            "new_over_library": med["new"] / med["library"], **extra,
            **({"share_of_f32_bound_new": 1e3 * flops / PEAK_F32_FLOPS / med["new"]}
               if exact else {}),
            "ms": times,
            "nvidia_smi": smi}), flush=True)
        del z, cn, cb, zm, zs, outs, wss
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
