"""STEGO correspondence-distillation loss, NHWC.

Counterpart of ``equss_tpu/losses/stego.py``: random coordinate sampling
by bilinear grid-sample, feature and code correlation tensors, and the
pos-intra / pos-inter / neg-inter terms with shifts and zero-clamping.
Random draws come from an explicit ``torch.Generator`` on the tensors'
device; ``sample_override`` replaces them so both packages can be fed the
same coordinates and permutations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class StegoLossConfig:
    """cfg['loss']['stego'] (fields and defaults as in the JAX package)."""

    pos_intra_weight: float = 0.67
    pos_inter_weight: float = 0.25
    neg_inter_weight: float = 0.63
    pos_intra_shift: float = 0.08
    pos_inter_shift: float = 0.02
    neg_inter_shift: float = 0.66
    zero_clamp: bool = True
    pointwise: bool = True
    stabilize: bool = False
    feature_samples: int = 11
    neg_samples: int = 5
    #: "exact": f32 correlations; "bf16": bf16 operands, f32 sums
    correlation_precision: str = "exact"


#: grid-sample routes (``_Sampler``): the JAX package's caps on the
#: bilinear-weight matrix per item and per batch.  Module-level so tests
#: can force either route.
_MATMUL_MAX_QHW = 2 ** 22
_MATMUL_MAX_BQHW = 2 ** 24


def _bilinear_weights(coords: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(b, hq, wq, 2) coordinates -> the (b, hq*wq, H*W) bilinear-weight
    matrix of border-padded, ``align_corners=True`` sampling."""
    b, q = coords.shape[0], coords.shape[1] * coords.shape[2]
    x = ((coords[..., 0] + 1.0) * 0.5 * (W - 1)).clamp(0.0, W - 1)
    y = ((coords[..., 1] + 1.0) * 0.5 * (H - 1)).clamp(0.0, H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    wx, wy = x - x0, y - y0
    x0, x1, y0, y1 = (v.long() for v in (x0, x1, y0, y1))
    iota = torch.arange(H * W, device=coords.device)
    wmat = torch.zeros((b, q, H * W), dtype=torch.float32, device=coords.device)
    for wc, yy, xx in (((1 - wx) * (1 - wy), y0, x0), (wx * (1 - wy), y0, x1),
                       ((1 - wx) * wy, y1, x0), (wx * wy, y1, x1)):
        # += sums coincident corners (border clamp) as the gather form does
        wmat = wmat + wc.reshape(b, q, 1) * (iota == (yy * W + xx).reshape(b, q, 1))
    return wmat


class _Sampler:
    """Samples (b, H, W, C) maps at one set of (b, hq, wq, 2) coordinates
    with ``F.grid_sample``'s semantics.  A query set whose weight matrix
    is small (the JAX package's caps) builds that matrix once and samples
    every map with one batched matmul, whose backward is one too; larger
    ones take ``F.grid_sample`` (the JAX package's 4-corner gather)."""

    def __init__(self, coords: torch.Tensor, H: int, W: int):
        b, hq, wq, _ = coords.shape
        self.coords, self.shape = coords, (hq, wq)
        q = hq * wq
        small = q * H * W <= _MATMUL_MAX_QHW and b * q * H * W <= _MATMUL_MAX_BQHW
        self.wmat = _bilinear_weights(coords, H, W) if small else None

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        b, H, W, C = t.shape
        if self.wmat is None:
            out = F.grid_sample(t.permute(0, 3, 1, 2), self.coords, mode="bilinear",
                                padding_mode="border", align_corners=True)
            return out.permute(0, 2, 3, 1)
        out = torch.bmm(self.wmat, t.reshape(b, H * W, C).float())
        return out.reshape(b, *self.shape, C)


def grid_sample(t: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear grid-sample with border padding and ``align_corners=True``
    (``F.grid_sample``'s semantics) for NHWC ``t`` (b, H, W, C);
    ``coords`` (b, hq, wq, 2) in [-1, 1] with x (width) first -> (b, hq,
    wq, C)."""
    return _Sampler(coords, t.shape[1], t.shape[2])(t)


def _norm(t: torch.Tensor) -> torch.Tensor:
    """Normalise over channels, eps 1e-10."""
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-10)


def tensor_correlation(a: torch.Tensor, b: torch.Tensor,
                       precision: str = "exact") -> torch.Tensor:
    """(n, h, w, c) x (n, i, j, c) -> (n, h, w, i, j) in f32.  ``bf16``
    rounds the operands to bf16 and sums their (exact) products in f32."""
    if precision == "bf16":
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    elif precision != "exact":
        raise ValueError(f"Unsupported correlation precision {precision}")
    return torch.einsum("nhwc,nijc->nhwij", a, b)


def super_perm(generator: torch.Generator, size: int, device) -> torch.Tensor:
    """A permutation whose fixed points are shifted by one (mod size)."""
    perm = torch.randperm(size, generator=generator, device=device)
    ar = torch.arange(size, device=device)
    return torch.where(perm == ar, perm + 1, perm) % size


def _helper(f1, f2, c1, c2, shift: float, cfg: StegoLossConfig) -> torch.Tensor:
    with torch.no_grad():            # the feature side is frozen
        fd = tensor_correlation(_norm(f1), _norm(f2), cfg.correlation_precision)
        if cfg.pointwise:
            old_mean = fd.mean()
            fd = fd - fd.mean(dim=(3, 4), keepdim=True)
            fd = fd - fd.mean() + old_mean
    cd = tensor_correlation(_norm(c1), _norm(c2), cfg.correlation_precision)
    min_val = 0.0 if cfg.zero_clamp else -9999.0
    cd_c = cd.clamp(min_val, 0.8) if cfg.stabilize else cd.clamp_min(min_val)
    return -cd_c * (fd - shift)


def stego_loss(
    generator: Optional[torch.Generator],
    orig_feats: torch.Tensor,
    orig_feats_pos: torch.Tensor,
    orig_code: torch.Tensor,
    orig_code_pos: torch.Tensor,
    cfg: StegoLossConfig,
    sample_override: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """STEGO loss over NHWC feature and code maps.

    ``sample_override``: ``(coords1, coords2, perms)`` replacing the random
    draws, coords (b, fs, fs, 2) in [-1, 1] and perms (neg_samples, b)
    int; ``generator`` may then be None."""
    b = orig_feats.shape[0]
    fs = cfg.feature_samples
    device = orig_feats.device
    if sample_override is not None:
        coords1, coords2, perms = sample_override
        perms = [p.long() for p in perms]
    else:
        coords1 = torch.rand((b, fs, fs, 2), generator=generator, device=device) * 2 - 1
        coords2 = torch.rand((b, fs, fs, 2), generator=generator, device=device) * 2 - 1
        perms = [super_perm(generator, b, device) for _ in range(cfg.neg_samples)]

    # the reference's ``sample`` swaps the two query axes first; one
    # sampler per coordinate set serves every map sampled at it
    H, W = orig_feats.shape[1:3]
    at1 = _Sampler(coords1.transpose(1, 2), H, W)
    at2 = _Sampler(coords2.transpose(1, 2), H, W)
    feats, code = at1(orig_feats), at1(orig_code)
    feats_pos, code_pos = at2(orig_feats_pos), at2(orig_code_pos)

    pos_intra = _helper(feats, feats, code, code, cfg.pos_intra_shift, cfg)
    pos_inter = _helper(feats, feats_pos, code, code_pos, cfg.pos_inter_shift, cfg)
    neg_inter = torch.cat([
        _helper(feats, at2(orig_feats[perm]), code, at2(orig_code[perm]),
                cfg.neg_inter_shift, cfg)
        for perm in perms[:cfg.neg_samples]], 0)
    return (cfg.pos_intra_weight * pos_intra.mean()
            + cfg.pos_inter_weight * pos_inter.mean()
            + cfg.neg_inter_weight * neg_inter.mean())
