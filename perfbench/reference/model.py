"""The EQUSS forward in plain PyTorch: the configuration's backbone
(``backbone_<name>.py``; DINO's ViT, arXiv:2104.14294, in
``backbone_dino.py``) on ImageNet-normalised images, the expansion head,
product quantization with l2-normalised subspaces, and the linear and
cluster probes, whose logits are resized bilinearly to the input.  NHWC
throughout, weights under the names of ``perfbench/weights.py``.

Departures from the published models, each the configuration's: the
patch embedding is a (kh, kw, rgb)-ordered matrix (a stride-8 convolution
written as a product); the position embedding is used as drawn (every
cell runs at the 28 x 28 grid it was drawn for).  GELU is the exact erf
form of the published ViT, where the program's bf16 backbone takes the
tanh form.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from perfbench import cell
from perfbench.reference.precision import rnd

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6

Weights = Dict[str, torch.Tensor]


def normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 (b, H, W, 3) -> f32 (x / 255 - mean) / std."""
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return (img.float() / 255.0 - mean) / std


def linear(x: torch.Tensor, W: Weights, name: str, prec: str) -> torch.Tensor:
    y = torch.matmul(rnd(x, prec), rnd(W[name + ".weight"], prec).t())
    return y + W[name + ".bias"]


def dense(W: Weights, x: torch.Tensor, w: Dict[str, Any], prec: str) -> torch.Tensor:
    """Normalised images (b, H, W, 3) -> the backbone's last normed patch
    tokens (b, H/p, W/p, d), f32, by the configuration's backbone module
    (``reference/backbone_<name>.py``)."""
    return cell.backbone(w).dense(W, x, w, prec)


def head(W: Weights, f: torch.Tensor, prec: str) -> torch.Tensor:
    """The expansion head: cluster1(f) + cluster2_fc2(relu(cluster2_fc1(f)))."""
    return (linear(f, W, "head.cluster1", prec)
            + linear(torch.relu(linear(f, W, "head.cluster2_fc1", prec)), W,
                     "head.cluster2_fc2", prec))


def l2n(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def pq_assign(z: torch.Tensor, codebook: torch.Tensor, prec: str,
              chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """z (n, M, d) raw, codebook (M, K, d) -> (indices (n, M), z_norm, z_q):
    each subspace vector and codeword l2-normalised, the nearest codeword
    by squared distance, z_q the raw codeword there (rounded to
    ``prec``, as the assignment's gather reads it)."""
    zn = l2n(z, 1e-12)
    cn = rnd(l2n(codebook, 1e-12), prec)
    c_sq = (cn * cn).sum(-1)
    idx = []
    with torch.no_grad():
        for s in range(0, z.shape[0], chunk):
            zc = rnd(zn[s:s + chunk], prec)
            cross = torch.einsum("nmd,mkd->nmk", zc, cn)
            dist = (zc * zc).sum(-1, keepdim=True) + c_sq - 2.0 * cross
            idx.append(dist.argmin(-1))
    idx = torch.cat(idx)
    m = torch.arange(codebook.shape[0], device=z.device)
    z_q = rnd(codebook, prec)[m, idx]
    return idx, zn, z_q


def upsample(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize, align_corners False."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def probe_logits(W: Weights, z: torch.Tensor, prec: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(linear logits, cluster inner products) at feature resolution."""
    lin = linear(z, W, "probes.linear_probe.linear", prec)
    inner = torch.matmul(rnd(l2n(z, 1e-12), prec),
                         rnd(l2n(W["probes.cluster_probe.clusters"], 1e-12), prec).t())
    return lin, inner


def features(W: Weights, img: torch.Tensor, w: Dict[str, int], precs: Dict[str, str]
             ) -> torch.Tensor:
    """uint8 images -> the straight-through quantized code z_q (b, gh, gw,
    hidden) the probes read at inference."""
    code = head(W, dense(W, normalize(img), w, precs["backbone"]), precs["head"])
    b, gh, gw, hid = code.shape
    M = w["num_pq"]
    _, zn, zq = pq_assign(code.reshape(-1, M, hid // M), W["pq.codebook"], precs["pq"])
    return (zn + (zq - zn)).reshape(b, gh, gw, hid)


@torch.no_grad()
def logits(W: Weights, img: torch.Tensor, w: Dict[str, int], precs: Dict[str, str],
           block: int = 16) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """uint8 images (b, H, W, 3) on the device -> per block of ``block``
    images, its first row and each probe's scores at the input's
    resolution (``linear``: logits; ``cluster``: inner products)."""
    for s in range(0, img.shape[0], block):
        part = img[s:s + block]
        lin, inner = probe_logits(W, features(W, part, w, precs), precs["probes"])
        hw = tuple(part.shape[1:3])
        yield s, {"linear": upsample(lin, hw), "cluster": upsample(inner, hw)}


def predict(W: Weights, img: torch.Tensor, w: Dict[str, int], precs: Dict[str, str],
            block: int = 16) -> Dict[str, torch.Tensor]:
    """``cluster_preds`` and ``linear_preds`` (b, H, W) int64."""
    out = {"cluster_preds": [], "linear_preds": []}
    for _, scores in logits(W, img, w, precs, block):
        for probe, sc in scores.items():
            out[f"{probe}_preds"].append(sc.argmax(-1))
    return {k: torch.cat(v) for k, v in out.items()}
