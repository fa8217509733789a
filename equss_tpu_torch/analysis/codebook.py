"""Codebook analysis: per-class codeword entropy, inter-class similarity,
codebook usage and DINO feature correspondence.

Counterpart of ``equss_tpu/analysis/codebook.py`` (the reference's
cross_entropy.py, edit_distance.py and plot_dino_correspondence.py as
functions).  Each runs on the device of its input tensors (numpy arrays
are taken as CPU tensors): the counts are ``index_add_`` of int64 ones,
so nothing is read back to the host, and the entropies are f64, as the
JAX package's numpy gives them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def _tensor(x: Any) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def per_class_codeword_entropy(indices: Any, labels: Any, num_classes: int,
                               num_codebook: int) -> Dict[str, torch.Tensor]:
    """How many codewords a class uses: indices (N, h, w, M) codeword ids
    and labels (N, h, w) class ids (outside [0, num_classes) ignored) ->
    ``counts`` (C, M, K) int64, ``entropy`` (C, M) f64 of each class's
    codeword distribution per subspace (0 for an absent class) and
    ``mean_entropy_per_class`` (C,)."""
    indices, labels = _tensor(indices), _tensor(labels)
    M, K, C = indices.shape[-1], num_codebook, num_classes
    flat_idx = indices.reshape(-1, M).long()
    flat_lab = labels.reshape(-1).long()
    valid = (flat_lab >= 0) & (flat_lab < C)
    m = torch.arange(M, device=flat_idx.device)
    key = (flat_lab.clamp(0, C - 1)[:, None] * M + m) * K + flat_idx       # (n, M)
    counts = torch.zeros(C * M * K, dtype=torch.int64, device=flat_idx.device).index_add_(
        0, key.reshape(-1), valid[:, None].expand(-1, M).reshape(-1).long()).reshape(C, M, K)
    probs = counts.double() / counts.sum(-1, keepdim=True).clamp(min=1).double()
    ent = -torch.where(probs > 0, probs * torch.log(probs), torch.zeros_like(probs)).sum(-1)
    return {"counts": counts, "entropy": ent, "mean_entropy_per_class": ent.mean(-1)}


def inter_class_similarity(features: Any, labels: Any, num_classes: int) -> torch.Tensor:
    """(C, C) cosine similarity between the per-class means of the
    (quantized) features (N, h, w, D) over the pixels of each class of
    labels (N, h, w); a class without pixels has a zero mean and zero
    similarity.  The sums are f64."""
    features, labels = _tensor(features), _tensor(labels)
    D = features.shape[-1]
    flat_f = features.reshape(-1, D).double()
    flat_l = labels.reshape(-1).long()
    valid = (flat_l >= 0) & (flat_l < num_classes)
    cls = flat_l.clamp(0, num_classes - 1)
    sums = torch.zeros((num_classes, D), dtype=torch.float64, device=flat_f.device).index_add_(
        0, cls, flat_f * valid[:, None])
    n = torch.zeros(num_classes, dtype=torch.float64, device=flat_f.device).index_add_(
        0, cls, valid.double())
    means = sums / n.clamp(min=1)[:, None]
    normed = means / torch.linalg.vector_norm(means, dim=-1, keepdim=True).clamp(min=1e-12)
    return normed @ normed.T


def codebook_usage_heatmap(indices: Any, num_codebook: int) -> torch.Tensor:
    """(M, K) int64 usage counts of indices (N, h, w, M)."""
    indices = _tensor(indices)
    M, K = indices.shape[-1], num_codebook
    flat = indices.reshape(-1, M).long() + K * torch.arange(M, device=indices.device)
    return torch.zeros(M * K, dtype=torch.int64, device=indices.device).index_add_(
        0, flat.reshape(-1), torch.ones(flat.numel(), dtype=torch.int64,
                                        device=indices.device)).reshape(M, K)


def dino_correspondence(feat_a: Any, feat_b: Any, query_yx: Tuple[int, int]) -> torch.Tensor:
    """(h, w) cosine similarity of one query patch of image A's dense
    features (h, w, C) against every patch of image B's, in the features'
    dtype."""
    fa, fb = _tensor(feat_a), _tensor(feat_b)
    q = fa[query_yx[0], query_yx[1]]
    q = q / torch.linalg.vector_norm(q).clamp(min=1e-12)
    fbn = fb / torch.linalg.vector_norm(fb, dim=-1, keepdim=True).clamp(min=1e-12)
    return fbn @ q
