"""Two builds of the packed attention kernel, side by side on one card.

    python3 -m equss_tpu_torch.tools.attention_ab OLD.cu

``OLD.cu`` is an earlier version of ``csrc/attention_qkv.cu`` with the
same ``attention_qkv_launch`` C entry.  Both sources are compiled with the
port's nvcc flags (in parallel, into ``_build/ab/``); each build's ptxas
register, shared-memory and spill lines are printed.  At the serving and
the train shape both builds run on the same input, their outputs must be
bit-identical, and they are timed in turns (old, new, new, old, repeated)
with CUDA events over back-to-back launches.  Prints the card's name and
power limit, one JSON line per build and per shape, and exits non-zero if
a build fails or the outputs differ.
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

SHAPES = (("serve", 128), ("train", 32))    # (name, B) at N = 785, H = 6, hd = 64
N, H, HD = 785, 6, 64


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
                 if re.search(r"registers|spill|smem", ln)]
        print(json.dumps({"build": name, "rc": proc.returncode, "ptxas": ptxas}),
              flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).attention_qkv_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        libs[name] = fn
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
    for shape, B in SHAPES:
        qkv = torch.randn((B, N, 3 * H * HD), generator=g, device="cuda").to(torch.bfloat16)
        outs = {k: torch.empty((B, N, H * HD), dtype=torch.bfloat16, device="cuda")
                for k in libs}

        def run(k):
            err = libs[k](qkv.data_ptr(), outs[k].data_ptr(), B, N, H, N, scale, stream)
            if err:
                raise RuntimeError(f"{k} launch failed: CUDA error {err}")

        for k in libs:
            run(k)
        torch.cuda.synchronize()
        same = bool(torch.equal(outs["old"], outs["new"]))
        ok &= same
        times = {k: [] for k in libs}
        for _ in range(3):
            for k in ("old", "new", "new", "old"):
                times[k].append(_time_ms(lambda: run(k)))
        print(json.dumps({"shape": shape, "qkv": [B, N, 3 * H * HD],
                          "bit_identical": same,
                          "median_ms": {k: statistics.median(v) for k, v in times.items()},
                          "ms": times, "nvidia_smi": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
