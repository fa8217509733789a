"""The arithmetic the benchmark judges by: model FLOPs, kernel work and
bytes, and one H100 SXM's peaks.  Frozen here, so that a change to the
program cannot move it.

The inference counts are a copy of ``equss_tpu_torch/tools/flops.py``
(2 x MACs of every matmul the model needs; ViT-S/8 at 224^2 46.69
GFLOP/img, ViT-B/8 160.10); the backbone's share is its module's
``flops`` (``reference/backbone_<name>.py``).  The train-step count is this file's own:
each term is a function below.  A roofline's least time is the larger of
a kernel's FLOPs over the bf16 peak and its bytes over the HBM rate, each
input byte counted once and each output byte once, from the shapes and
dtypes of the cell.
"""
from __future__ import annotations

from typing import Any, Dict

from perfbench import cell as cells

# one H100 SXM (NVIDIA data sheet; dense, without sparsity, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # CUDA cores
PEAK_BYTES = 3.35e12            # HBM3


def head_flops(px: int, d: int, hidden: int) -> float:
    """The expansion head's forward over ``px`` feature pixels: d ->
    hidden, d -> d (ReLU), d -> hidden."""
    return 2 * px * (d * hidden + d * d + d * hidden)


def pq_flops(px: int, hidden: int, k: int) -> float:
    """The PQ assignment's cross terms: per pixel and subspace one
    (d_sub x K) dot, M * d_sub = hidden.  The gather is a lookup."""
    return 2 * px * hidden * k


def segment_flops_per_image(w: Dict[str, Any]) -> float:
    """``tools/flops.py``'s serving count: backbone, head, PQ (the probes
    and the resize, under 0.3% of it, are not counted)."""
    px = (w["res"] // w["patch"]) ** 2
    return (cells.backbone(w).flops(w)
            + head_flops(px, w["embed_dim"], w["hidden"])
            + pq_flops(px, w["hidden"], w["num_codebook"]))


def train_flops_terms(w: Dict[str, Any], batch: int, classes: int) -> Dict[str, float]:
    """The terms of one pqgo train step on ``batch`` images and their
    ``batch`` kNN positives: the frozen backbone's forward on 2b images;
    the head's forward on 2b and its backward (every weight gradient, and
    the gradient into the ReLU branch; the backbone features take none);
    PQ distances on b; STEGO's sampling (7 maps a side: the image, its
    positive and 5 negatives, features and codes) and its 7 correlation
    pairs, with the code side's backward; the probes' forward and weight
    gradients and the linear logits' resize to the input and back."""
    res, p, d, hid = w["res"], w["patch"], w["embed_dim"], w["hidden"]
    g = res // p
    px = g * g
    q = w.get("feature_samples", 0) ** 2      # no STEGO loss: no STEGO terms
    b2 = 2 * batch
    head = head_flops(px, d, hid)
    sample = 2 * q * px                       # one query set over one map, per channel
    corr = 2 * q * q                          # one correlation pair, per channel
    resize = 2 * (res * g * g + res * res * g)    # 28^2 -> res^2, per channel
    return {
        "backbone_fwd": b2 * cells.backbone(w).flops(w),
        "head_fwd": b2 * head,
        "head_bwd": b2 * (head + 2 * px * hid * d),
        "pq_dist": batch * pq_flops(px, hid, w["num_codebook"]),
        "stego_fwd": batch * 7 * (sample * (d + hid) + corr * (d + hid)),
        "stego_bwd": batch * 7 * (sample * hid + 2 * corr * hid),
        "probes": batch * (2 * 2 * px * hid * classes + 2 * px * hid * classes
                           + 2 * resize * classes),
    }


def train_flops_per_step(w: Dict[str, Any], batch: int, classes: int) -> float:
    return sum(train_flops_terms(w, batch, classes).values())


def least_time(flops: float, nbytes: float) -> float:
    """Seconds: the larger of FLOPs at the bf16 peak and bytes at HBM's."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def attention_work(batch: int, tokens: int, d: int) -> Dict[str, float]:
    """One layer's attention over packed bf16 qkv (batch, tokens, 3d) ->
    (batch, tokens, d): q k^T and p v, 4 * batch * tokens^2 * d FLOPs;
    qkv read once, the output written once."""
    return {"flops": 4.0 * batch * tokens * tokens * d,
            "bytes": 2.0 * batch * tokens * 3 * d + 2.0 * batch * tokens * d}


def pq_work(rows: int, hidden: int, num_pq: int, k: int) -> Dict[str, float]:
    """One PQ assignment of ``rows`` f32 vectors of width ``hidden`` in
    ``num_pq`` subspaces of ``k`` codewords: the cross terms; z, the
    normalised and the raw codebook read once (f32), the indices (int32),
    z_norm and z_q (f32) written once."""
    d_sub = hidden // num_pq
    return {"flops": 2.0 * rows * hidden * k,
            "bytes": 4.0 * (3 * rows * hidden + 2 * num_pq * k * d_sub + rows * num_pq)}
