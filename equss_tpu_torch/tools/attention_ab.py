"""Two builds of the attention kernel, side by side on one card.

    python3 -m equss_tpu_torch.tools.attention_ab OLD.cu

``OLD.cu`` is an earlier version of ``csrc/attention_qkv.cu`` with the
same ``attention_qkv_launch`` and ``attention_launch`` C entries.  Both
sources are compiled with the port's nvcc flags (in parallel, into
``_build/ab/``); each build's ptxas register, shared-memory, spill and
wgmma-serialization lines are printed.  At the serving (b = 128 and
b = 1), train, 320^2 validation and ViT-B shapes of the packed entry, and
at the serving shape of the separate-q/k/v entry, both builds run on the
same input.  Each
output is held against the plain version (``attention_qkv_reference``)
with the kernel's bar, one bf16 ulp of the output's scale; the two
builds' outputs need not be bit-identical (``bit_identical`` says whether
they are), since a changed design may round at other points.  Then both
builds and ``F.scaled_dot_product_attention`` (the yardstick) are timed in
turns (old, new, sdpa, sdpa, new, old, three times) with CUDA events over
back-to-back launches; beside each build's device time, its host time per
call (ctypes call, tensor-map encoding and launch; a b = 1 shape shows it
where it matters).  Prints the card's name and power limit, one JSON
line per build and per shape, and exits non-zero if a build or a launch
fails or an output misses the bar.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from equss_tpu_torch.ops import _build
from equss_tpu_torch.ops.attention import attention_qkv_reference

SHAPES = (  # name, entry, B, N, H at hd = 64
    ("serve", "packed", 128, 785, 6),
    ("train", "packed", 32, 785, 6),
    ("val_320", "packed", 32, 1601, 6),
    ("vit_b", "packed", 32, 785, 12),
    ("separate_serve", "separate", 128, 785, 6),
    ("serve_b1", "packed", 1, 785, 6),
)
HD = 64


def _compile(sources):
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        ptxas = [ln.strip() for ln in log.splitlines()
                 if re.search(r"registers|spill|smem|C7515", ln)]
        print(json.dumps({"build": name, "rc": proc.returncode, "ptxas": ptxas}),
              flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        packed, separate = cdll.attention_qkv_launch, cdll.attention_launch
        packed.restype = separate.restype = ctypes.c_int
        packed.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
            + [ctypes.c_float, ctypes.c_void_p]
        separate.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        libs[name] = {"packed": packed, "separate": separate}
    return libs


def _time_ms(fn, iters: int = 20) -> float:
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


def _host_us(fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` (wrapper work, tensor-map encoding and
    the launch itself), the queue drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = _compile({"old": Path(argv[0]).resolve(),
                     "new": _build.CSRC_DIR / "attention_qkv.cu"})
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    scale = HD ** -0.5
    ok = True
    for shape, entry, B, N, H in SHAPES:
        C = H * HD
        qkv = torch.randn((B, N, 3 * C), generator=g, device="cuda").to(torch.bfloat16)
        x = qkv.view(B, N, 3, H, HD)
        q, k, v = (x[:, :, i].contiguous() for i in range(3))   # (B, N, H, HD)
        outs = {name: torch.empty((B, N, C), dtype=torch.bfloat16, device="cuda")
                for name in libs}

        def run(name):
            if entry == "packed":
                err = libs[name]["packed"](qkv.data_ptr(), outs[name].data_ptr(),
                                           B, N, H, N, scale, stream)
            else:
                err = libs[name]["separate"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             outs[name].data_ptr(), B, N, H, HD, N,
                                             scale, stream)
            if err:
                raise RuntimeError(f"{name} launch failed: error {err}")

        for name in libs:
            run(name)
        torch.cuda.synchronize()
        ref = attention_qkv_reference(qkv, H, scale).float()
        tolerance = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
        errs = {name: (o.float() - ref).abs().max().item() for name, o in outs.items()}
        ok &= all(e <= tolerance for e in errs.values())
        qt, kt, vt = x.permute(2, 0, 3, 1, 4)
        times = {name: [] for name in ("old", "new", "sdpa")}
        host = {name: [] for name in libs}
        for _ in range(3):
            for name in ("old", "new", "sdpa", "sdpa", "new", "old"):
                fn = (lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)) \
                    if name == "sdpa" else (lambda: run(name))
                times[name].append(_time_ms(fn))
                if name in host:
                    host[name].append(_host_us(fn))
        print(json.dumps({"shape": shape, "entry": entry, "qkv": [B, N, 3 * C],
                          "bit_identical": bool(torch.equal(outs["old"], outs["new"])),
                          "max_abs_err": errs, "tolerance": tolerance,
                          "median_ms": {k: statistics.median(v) for k, v in times.items()},
                          "host_us_per_call_median": {k: statistics.median(v)
                                                      for k, v in host.items()},
                          "ms": times, "nvidia_smi": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
