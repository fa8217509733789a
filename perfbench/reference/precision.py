"""Precisions of the reference and of its control.

The configuration states a precision for each part of the model: the
backbone's (``model.pretrained.precision``), the PQ assignment's
(``model.vq.assign_precision``) and STEGO's correlations
(``loss.stego.correlation_precision``); the head, the probes and the
optimizer run in f32.  The reference computes every part in f32.  The
control computes each part one step below what the configuration
states: bf16 for f32, fp8 (e4m3, one scale per tensor, as fp8 matrix
products take it) for bf16.  A precision applies to the operands of each
matrix product and to the codewords the assignment gathers; products
accumulate in f32, as the tensor cores do.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

PARTS = ("backbone", "head", "pq", "stego", "probes")
REFERENCE = {p: "f32" for p in PARTS}
LOWER = {"f32": "bf16", "bf16": "fp8"}
FP8_MAX = 448.0


def stated(cfg: Dict[str, Any]) -> Dict[str, str]:
    """Each part's precision as the configuration states it."""
    def name(v: str) -> str:
        return "bf16" if v == "bf16" else "f32"
    return {"backbone": name(cfg["model"]["pretrained"].get("precision", "f32")),
            "head": "f32",
            "pq": name(cfg["model"]["vq"].get("assign_precision", "exact")),
            "stego": name(cfg.get("loss", {}).get("stego", {}).get("correlation_precision",
                                                                    "exact")),
            "probes": "f32"}


def control(cfg: Dict[str, Any]) -> Dict[str, str]:
    return {p: LOWER[v] for p, v in stated(cfg).items()}


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` (f32) rounded to ``prec`` and back to f32; the gradient
    passes through the rounding unchanged."""
    if prec == "f32":
        return x
    with torch.no_grad():
        if prec == "bf16":
            r = x.to(torch.bfloat16).float()
        elif prec == "fp8":
            scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
            r = (x / scale).to(torch.float8_e4m3fn).float() * scale
        else:
            raise ValueError(f"unknown precision {prec}")
    return x + (r - x).detach() if x.requires_grad else r


class tf32_off:
    """Matrix products and convolutions in full f32 inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
