"""Batched Lloyd k-means on the device.

Counterpart of ``equss_tpu/ops/kmeans.py``: ``_assign``,
``kmeans_plus_plus_init`` and ``kmeans``, vectorised over M independent
subspaces (a leading batch axis) and computed in f32.  The assignment is
the pairwise-L2 product and a first-minimum argmin, as in the PQ
quantizer; the update is a scatter-add mean, and a dead cluster keeps its
previous centroid.

k-means++ keeps a running minimum of the squared distance to the
centroids chosen so far: each seeding step computes one (M, n) distance
to the new centroid, where the JAX package recomputes the masked
(M, n, k) distance to every slot at each of its k - 1 steps (about 80
TFLOP per call at NewVQ's stage-1 shape, n = 25 088, d = 384,
k = 2048).  Each entry of the minimum is the same function of the same
centroid.

The random draws come from the caller's ``generator`` unless given:
``first`` (M,) and ``gumbel`` (k - 1, M, n) for k-means++, ``init_idx``
(M, k) for the random seeding, so a test can feed JAX's own draws.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# k-means++ draws its Gumbel noise this many seeding steps at a time
_GUMBEL_BLOCK = 256


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """x (M, n, d), centroids (M, K, d) -> (M, n) int64 indices of the
    nearest centroid, the first of equal ones."""
    x_sq = (x * x).sum(-1)[..., None]
    c_sq = (centroids * centroids).sum(-1)[:, None, :]
    cross = torch.bmm(x, centroids.transpose(1, 2))
    return (x_sq + c_sq - 2.0 * cross).argmin(-1)


def gumbel(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def kmeans_plus_plus_init(x: torch.Tensor, k: int,
                          generator: Optional[torch.Generator] = None, *,
                          first: Optional[torch.Tensor] = None,
                          gumbel_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-means++ seeding, batched: x (M, n, d) -> (M, k, d).  The first
    centroid of each subspace is row ``first``; each later one is the
    argmax of log(D^2 + 1e-12) plus Gumbel noise (D^2-weighted sampling by
    the Gumbel-max trick), D^2 the squared distance to the nearest
    centroid chosen so far, clipped at 0."""
    M, n, d = x.shape
    if first is None:
        first = torch.randint(0, n, (M,), generator=generator, device=x.device)
    rows = torch.arange(M, device=x.device)
    x_sq = (x * x).sum(-1)                                   # (M, n)
    centroids = torch.zeros((M, k, d), dtype=x.dtype, device=x.device)
    c = x[rows, first.to(x.device).long()]                   # (M, d)
    centroids[:, 0] = c
    min_d2 = torch.full((M, n), float("inf"), device=x.device)
    noise = None
    for i in range(1, k):
        d2 = x_sq + (c * c).sum(-1)[:, None] - 2.0 * torch.bmm(x, c[:, :, None])[..., 0]
        min_d2 = torch.minimum(min_d2, d2)
        if gumbel_noise is not None:
            g = gumbel_noise[i - 1].to(x.device)
        else:
            j = (i - 1) % _GUMBEL_BLOCK
            if j == 0:
                noise = gumbel(generator, (min(_GUMBEL_BLOCK, k - i), M, n), x.device)
            g = noise[j]
        pick = (torch.log(min_d2.clamp_min(0.0) + 1e-12) + g).argmax(-1)
        c = x[rows, pick]
        centroids[:, i] = c
    return centroids


@torch.no_grad()
def kmeans(x: torch.Tensor, k: int, n_iters: int = 25, plus_plus: bool = True,
           generator: Optional[torch.Generator] = None, *,
           first: Optional[torch.Tensor] = None,
           gumbel_noise: Optional[torch.Tensor] = None,
           init_idx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (n, d) or (M, n, d) -> (centroids (.., k, d) f32, assignments
    (.., n) int64) after ``n_iters`` Lloyd steps from k-means++ seeds
    (``plus_plus``) or from k distinct rows drawn without replacement
    across all subspaces (``init_idx``, (M, k) flat row indices < n)."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    x = x.float()
    M, n, d = x.shape
    if plus_plus:
        centroids = kmeans_plus_plus_init(x, k, generator, first=first,
                                          gumbel_noise=gumbel_noise)
    else:
        if init_idx is None:
            init_idx = torch.randperm(n, generator=generator, device=x.device)[:M * k]
        idx = init_idx.to(x.device).long().reshape(M, k)
        centroids = torch.gather(x, 1, idx[..., None].expand(M, k, d))
    flat_offset = (k * torch.arange(M, device=x.device))[:, None]
    for _ in range(n_iters):
        flat = (_assign(x, centroids) + flat_offset).reshape(-1)
        counts = torch.zeros(M * k, device=x.device).index_add_(
            0, flat, torch.ones(flat.shape, device=x.device)).reshape(M, k)
        sums = torch.zeros((M * k, d), device=x.device).index_add_(
            0, flat, x.reshape(-1, d)).reshape(M, k, d)
        new_c = sums / counts.clamp_min(1.0)[..., None]
        centroids = torch.where((counts > 0)[..., None], new_c, centroids)
    assign = _assign(x, centroids)
    if squeeze:
        return centroids[0], assign[0]
    return centroids, assign
