"""Model FLOPs of the EQUSS forward and the H100's peak rates: the port's
MFU basis.

The port's copy of ``tools/flops.py``.  It counts algorithmic FLOPs
(2 x MACs of every matmul and convolution the model needs), the usual
MFU numerator, not the work an implementation adds (padding, the
codeword gather as a product):

  backbone  ``models/vit.py``   (patch embedding, 12 blocks)
  head      ``models/heads.py`` (the expansion head)
  PQ        ``ops/quantizer.py`` (each pixel's d_sub x K dot per subspace)

ViT-S/8 at 224^2 is 46.69 GFLOP/img in all, ViT-B/8 160.10.

The peaks are one H100 SXM's, from NVIDIA's H100 Tensor Core GPU data
sheet (dense, without sparsity, at the 700 W power limit): 989 TFLOP/s
bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s of
HBM3.  A card set below 700 W runs below them; state its power limit
beside any share of them.

    python3 -m equss_tpu_torch.tools.flops
"""
from __future__ import annotations

import json

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12        # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12

MODEL_WIDTHS = {"vit_small": (384, 12, 6), "vit_base": (768, 12, 12)}   # d, depth, heads


def vit_backbone_flops(img: int = 224, patch: int = 8, d: int = 384, depth: int = 12,
                       heads: int = 6, mlp_ratio: int = 4) -> float:
    """FLOPs of one image through the ViT encoder."""
    g = img // patch
    n = g * g + 1               # tokens, CLS included
    patch_embed = 2 * g * g * (patch * patch * 3) * d
    qkv = 2 * n * d * (3 * d)
    scores = 2 * n * n * d      # q k^T
    attnv = 2 * n * n * d       # p v
    proj = 2 * n * d * d
    mlp = 2 * 2 * n * d * (mlp_ratio * d)
    return patch_embed + depth * (qkv + scores + attnv + proj + mlp)


def head_flops(img: int = 224, patch: int = 8, d: int = 384, hidden: int = 1024) -> float:
    """The expansion head per feature pixel: d -> hidden, d -> d (ReLU),
    d -> hidden."""
    px = (img // patch) ** 2
    return 2 * px * (d * hidden + d * d + d * hidden)


def pq_flops(img: int = 224, patch: int = 8, hidden: int = 1024, num_pq: int = 64,
             k: int = 256) -> float:
    """The PQ assignment's cross terms: per pixel and subspace one
    (d_sub x K) dot, d_sub = hidden / num_pq.  The codeword gather is a
    lookup: 0 FLOPs."""
    px = (img // patch) ** 2
    return 2 * px * num_pq * (hidden // num_pq) * k


def equss_inference_flops(model: str = "vit_small", img: int = 224) -> float:
    """Model FLOPs per image of the serving forward (PQ 64 x 256)."""
    d, depth, heads = MODEL_WIDTHS[model]
    return (vit_backbone_flops(img=img, d=d, depth=depth, heads=heads)
            + head_flops(img=img, d=d) + pq_flops(img=img))


def mfu(imgs_per_sec: float, flops_per_img: float,
        peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """Model-FLOP utilization in [0, 1] against ``peak_flops`` (default
    the H100's dense bf16 rate)."""
    return imgs_per_sec * flops_per_img / peak_flops


def main(argv=None) -> dict:
    del argv
    out = {"gflop_per_img_224": {}, "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
           "peak_f32_tflops": PEAK_F32_FLOPS / 1e12, "peak_tb_per_s": PEAK_BYTES / 1e12}
    for m, (d, depth, heads) in MODEL_WIDTHS.items():
        out["gflop_per_img_224"][m] = {
            "backbone": vit_backbone_flops(d=d, depth=depth, heads=heads) / 1e9,
            "total": equss_inference_flops(m) / 1e9}
    print(json.dumps({"tool": "flops", **out}), flush=True)
    return out


if __name__ == "__main__":
    main()
