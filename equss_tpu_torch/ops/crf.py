"""Dense CRF refinement (Krähenbühl and Koltun's mean field).

Counterpart of ``equss_tpu/ops/crf.py``, the final evaluation's
refinement of the probes' predictions: the unary is the log-softmax of
the probe, the pairwise terms a Gaussian one (sxy = 1, compat 3) and a
bilateral one (sxy = 67, srgb = 3, compat 4), 10 mean-field iterations,
symmetric kernel normalisation.  The JAX package computes it with plain
``jnp`` (no Pallas kernel), so PyTorch ops are its port.

The bilateral message pass is exact and never materialises the N x N
kernel: it streams over row blocks of ``CRFConfig.block`` pixels, each
a (B, 5) x (5, N) distance product, an exponential and a (B, N) x (N, C)
message product.  Numerics follow the JAX package:

* the features are rounded to bf16 once, and both the squared norms and
  the cross term come from the rounded values, so the distance is exact
  for the (slightly perturbed) features instead of a cancellation of
  unrelated roundings;
* the messages are bf16 operands with an f32 result: on CUDA
  ``torch.mm(..., out_dtype=torch.float32)`` (a bf16 tensor-core
  product), on the CPU an f32 product of the bf16-rounded operands, the
  same sums (every product of two bf16 values is exact in f32); TF32
  cannot change either, since bf16 values are exact in TF32.

Work of one bilateral pass at 320^2 (N = 102 400): N^2 = 1.05e10
exponentials, 2 N^2 C = 5.7e11 flop for the message product at C = 27
and 2 N^2 5 = 1.0e11 for the distances.  ``dense_crf`` runs 1 + max_iter
such passes.

``dense_crf_naive`` materialises the kernels: the oracle for tiny images.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from equss_tpu_torch.data.transforms import unnormalize_images


@dataclasses.dataclass(frozen=True)
class CRFConfig:
    """Defaults as the JAX package's (pydensecrf's settings)."""

    max_iter: int = 10
    pos_w: float = 3.0        # Gaussian (spatial) compat
    pos_xy_std: float = 1.0
    bi_w: float = 4.0         # bilateral compat
    bi_xy_std: float = 67.0
    bi_rgb_std: float = 3.0
    block: int = 512          # row-block size of the streamed kernel
    # pydensecrf keeps the self term in messages; True gives the
    # textbook mean field instead
    exclude_self: bool = False


def _bilateral_features(img_rgb255: torch.Tensor, cfg: CRFConfig) -> torch.Tensor:
    """(H, W, 3) in [0, 255] -> (N, 5) sigma-normalised features."""
    H, W, _ = img_rgb255.shape
    dev = img_rgb255.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    f = torch.cat([(xs / cfg.bi_xy_std)[..., None], (ys / cfg.bi_xy_std)[..., None],
                   img_rgb255 / cfg.bi_rgb_std], dim=-1)
    return f.reshape(H * W, 5)


def _message_product(k: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """k (B, N) @ values (N, C) in f32; bf16 operands give an f32 result."""
    if k.dtype == torch.float32:
        return k @ values
    return (torch.mm(k, values, out_dtype=torch.float32) if k.is_cuda
            else k.float() @ values.float())


def _blocked_kernel_apply(feats: torch.Tensor, values: torch.Tensor, block: int,
                          message_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Exact ``K @ values`` with ``K_ij = exp(-|f_i - f_j|^2 / 2)`` over
    ``feats`` (N, F) rounded to bf16 and ``values`` (N, C) in
    ``message_dtype``, streamed over row blocks of ``block`` pixels; the
    last block holds the remainder (the JAX package pads it with zero
    rows and drops their outputs: the same rows).

    Each block computes ``-d2 / 2 = -(|f_i|^2 + |f_j|^2) / 2 + f_i . f_j``
    by one ``addmm_`` onto the halved norms: a power-of-two scale of the
    JAX package's ``|f_i|^2 + |f_j|^2 - 2 f_i . f_j`` that rounds the same
    way, then ``min(., 0)`` (its ``max(d2, 0)``) and the exponential,
    written in ``message_dtype`` directly."""
    n = feats.shape[0]
    fr = feats.to(torch.bfloat16).float()              # bf16-valued, f32 carrier
    half_sq = -0.5 * (fr * fr).sum(-1)                 # (N,)
    fr_t = fr.t().contiguous()
    vals = values.to(message_dtype)
    out = torch.empty((n, values.shape[1]), dtype=torch.float32, device=feats.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        t = half_sq[s:e, None] + half_sq[None, :]       # (B, N)
        t.addmm_(fr[s:e], fr_t)
        t.clamp_max_(0.0)
        k = torch.exp(t, out=torch.empty_like(t, dtype=message_dtype)) \
            if message_dtype != torch.float32 else t.exp_()
        out[s:e] = _message_product(k, vals)
    return out


def _gaussian_conv(values: torch.Tensor, sigma: float, radius: int = 4) -> torch.Tensor:
    """Separable truncated spatial Gaussian filter of (H, W, C) values:
    zero padding, the unnormalised 1-D kernel ``exp(-x^2 / 2 sigma^2)``
    for |x| <= radius, taps added in order."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=values.device)
    k1d = torch.exp(-0.5 * (x / sigma) ** 2)

    def conv_axis(v: torch.Tensor, axis: int) -> torch.Tensor:
        pad = [0, 0] * v.ndim
        pad[2 * (v.ndim - 1 - axis)] = pad[2 * (v.ndim - 1 - axis) + 1] = radius
        vp = F.pad(v, pad)
        out = torch.zeros_like(v)
        for i in range(2 * radius + 1):
            out = out + k1d[i] * vp.narrow(axis, i, v.shape[axis])
        return out

    return conv_axis(conv_axis(values, 0), 1)


def dense_crf(img: torch.Tensor, log_probs: torch.Tensor,
              cfg: CRFConfig = CRFConfig(), *,
              message_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Refined probabilities (H, W, C) after mean-field inference on one
    image: ``img`` (H, W, 3) ImageNet-normalised, ``log_probs`` (H, W, C)
    the unary (log-softmax).  Per iteration ``Q = softmax(log_p + pos_w *
    gauss_msg + bi_w * bilat_msg)`` with symmetric kernel normalisation.
    ``message_dtype`` is the bilateral messages' (bf16, as in the JAX
    package; ``torch.float32`` gives the f32 pass to hold it against)."""
    H, W, C = log_probs.shape
    n = H * W
    rgb255 = unnormalize_images(img.float()).clamp(0.0, 1.0) * 255.0
    feats = _bilateral_features(rgb255, cfg)

    # symmetric normalisation degrees (filter of ones), self included
    ones = torch.ones((n, 1), dtype=torch.float32, device=img.device)
    deg_bi = _blocked_kernel_apply(feats, ones, cfg.block, message_dtype)[:, 0]
    inv_sqrt_bi = torch.rsqrt(deg_bi.clamp_min(1e-20))[:, None]
    deg_sp = _gaussian_conv(torch.ones((H, W, 1), device=img.device), cfg.pos_xy_std)[..., 0]
    inv_sqrt_sp = torch.rsqrt(deg_sp.clamp_min(1e-20)).reshape(n, 1)

    log_p = torch.log_softmax(log_probs.float(), dim=-1).reshape(n, C)
    q = torch.softmax(log_p, dim=-1)
    for _ in range(cfg.max_iter):
        # bilateral message D^-1/2 K D^-1/2 q
        m_bi = _blocked_kernel_apply(feats, q * inv_sqrt_bi, cfg.block, message_dtype) \
            * inv_sqrt_bi
        # spatial message by the separable convolution
        q2 = (q * inv_sqrt_sp).reshape(H, W, C)
        m_sp = _gaussian_conv(q2, cfg.pos_xy_std).reshape(n, C) * inv_sqrt_sp
        if cfg.exclude_self:
            m_bi = m_bi - q * inv_sqrt_bi ** 2
            m_sp = m_sp - q * inv_sqrt_sp ** 2
        # Potts compatibility: energy -w * msg -> logits += w * msg
        logits = log_p + cfg.pos_w * m_sp + cfg.bi_w * m_bi
        q = torch.softmax(logits, dim=-1)
    return q.reshape(H, W, C)


def dense_crf_naive(img: torch.Tensor, log_probs: torch.Tensor,
                    cfg: CRFConfig = CRFConfig()) -> torch.Tensor:
    """Dense-matrix oracle (materialises N x N in f32; tiny images only)."""
    H, W, C = log_probs.shape
    n = H * W
    rgb255 = unnormalize_images(img.float()).clamp(0.0, 1.0) * 255.0
    fb = _bilateral_features(rgb255, cfg)
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :].expand(H, W)
    fs = torch.stack([xs / cfg.pos_xy_std, ys / cfg.pos_xy_std], -1).reshape(n, 2)

    def norm(f: torch.Tensor) -> torch.Tensor:
        k = torch.exp(-0.5 * ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1))
        inv = torch.rsqrt(k.sum(-1).clamp_min(1e-20))
        kn = k * inv[:, None] * inv[None, :]
        if cfg.exclude_self:
            kn = kn - torch.diag(torch.diag(kn))
        return kn

    kn_bi, kn_sp = norm(fb), norm(fs)
    log_p = torch.log_softmax(log_probs.float(), dim=-1).reshape(n, C)
    q = torch.softmax(log_p, dim=-1)
    for _ in range(cfg.max_iter):
        logits = log_p + cfg.pos_w * (kn_sp @ q) + cfg.bi_w * (kn_bi @ q)
        q = torch.softmax(logits, dim=-1)
    return q.reshape(H, W, C)


def batched_crf(imgs: torch.Tensor, log_probs: torch.Tensor,
                cfg: CRFConfig = CRFConfig()) -> torch.Tensor:
    """``dense_crf`` of each image of a batch: (b, H, W, 3), (b, H, W, C)
    -> (b, H, W, C).  One image at a time, so the streamed blocks of one
    image are all that is held."""
    return torch.stack([dense_crf(i, lp, cfg) for i, lp in zip(imgs, log_probs)])
