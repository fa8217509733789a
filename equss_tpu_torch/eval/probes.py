"""Evaluation probes: linear probe and cluster lookup.

Counterpart of ``equss_tpu/eval/probes.py``.  The probes run at feature
resolution and their (num_classes)-channel logits are resized bilinearly
to the label resolution (``probe_res='feat'``, the JAX package's
default); ``probe_res='label'`` resizes the features first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equss_tpu_torch.models.vit import Dense
from equss_tpu_torch.ops.resize import resize2d


@dataclasses.dataclass(frozen=True)
class EvaluatorConfig:
    embed_dim: int
    num_classes: int
    extra_classes: int = 0
    #: cluster-probe assignment in the training loss: None is the hard
    #: one-hot assignment (the reference's default), a float the softmax
    #: of inner * alpha
    alpha: Optional[float] = None
    probe_res: str = "feat"     # 'feat' | 'label'
    with_cluster: bool = True


class LinearProbe(nn.Module):
    """1x1-conv linear probe: a Dense layer over channels, in f32."""

    def __init__(self, dim: int, num_classes: int, generator: torch.Generator):
        super().__init__()
        self.linear = Dense(dim, num_classes, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x, torch.float32)


class ClusterProbe(nn.Module):
    """Cosine cluster centroids ``clusters`` (n, dim), drawn N(0, 1)."""

    def __init__(self, num_clusters: int, dim: int, generator: torch.Generator):
        super().__init__()
        self.num_clusters = num_clusters
        self.clusters = nn.Parameter(torch.randn((num_clusters, dim), generator=generator))

    def inner_products(self, x: torch.Tensor) -> torch.Tensor:
        normed_clusters = self.clusters / torch.linalg.vector_norm(
            self.clusters, dim=1, keepdim=True).clamp_min(1e-12)
        normed_feat = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.einsum("bhwc,nc->bhwn", normed_feat, normed_clusters)

    def forward(self, x: torch.Tensor, alpha: Optional[float] = 2.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(loss, probs)``; ``alpha=None`` assigns each pixel to its
        nearest cluster, and gradients flow through the inner products
        only."""
        inner = self.inner_products(x)
        if alpha is None:
            probs = F.one_hot(inner.argmax(-1), self.num_clusters).float()
        else:
            probs = torch.softmax(inner * alpha, dim=-1)
        return -(probs * inner).sum(-1).mean(), probs


def masked_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    """Cross-entropy over the pixels whose label lies in [0, num_classes),
    averaged over them; logits (..., C), label (...) int."""
    mask = (label >= 0) & (label < num_classes)
    safe = torch.where(mask, label, torch.zeros_like(label)).long()
    ce = -torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return torch.where(mask, ce, torch.zeros_like(ce)).sum() / mask.sum().clamp_min(1)


class Evaluator(nn.Module):
    """Linear and cluster probes over (detached) features: losses and
    predictions at label resolution."""

    def __init__(self, cfg: EvaluatorConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.linear_probe = LinearProbe(cfg.embed_dim, cfg.num_classes, generator)
        self.cluster_probe = (
            ClusterProbe(cfg.num_classes + cfg.extra_classes, cfg.embed_dim, generator)
            if cfg.with_cluster else None)

    def forward(self, out: torch.Tensor, label: torch.Tensor, *,
                want_log_probs: bool = False) -> Dict[str, Any]:
        """out (b, h, w, D) features, label (b, H, W) int -> dict with
        ``linear_loss``, ``linear_preds`` and, with the cluster probe,
        ``cluster_loss`` and ``cluster_preds`` (int32, at (H, W)).
        ``want_log_probs`` adds the CRF's unaries at (H, W):
        ``linear_log_probs`` (log-softmax of the linear logits) and
        ``cluster_log_probs`` (log-softmax of the inner products times 2,
        whatever ``alpha`` the training loss uses)."""
        cfg = self.cfg
        label_hw = tuple(label.shape[-2:])
        if cfg.probe_res == "label" and tuple(out.shape[1:3]) != label_hw:
            out = resize2d(out, label_hw, "bilinear", align_corners=False)
        linear_logits = self.linear_probe(out)
        cluster_inner = cluster_loss = None
        if self.cluster_probe is not None:
            cluster_loss, _ = self.cluster_probe(out, alpha=cfg.alpha)
            cluster_inner = self.cluster_probe.inner_products(out)
        if tuple(linear_logits.shape[1:3]) != label_hw:
            linear_logits = resize2d(linear_logits, label_hw, "bilinear")
            if cluster_inner is not None:
                cluster_inner = resize2d(cluster_inner, label_hw, "bilinear")
        result: Dict[str, Any] = {
            "linear_loss": masked_cross_entropy(linear_logits, label, cfg.num_classes),
            "linear_preds": linear_logits.argmax(-1).to(torch.int32),
        }
        if cluster_inner is not None:
            result["cluster_loss"] = cluster_loss
            result["cluster_preds"] = cluster_inner.argmax(-1).to(torch.int32)
        if want_log_probs:
            result["linear_log_probs"] = torch.log_softmax(linear_logits, dim=-1)
            if cluster_inner is not None:
                result["cluster_log_probs"] = torch.log_softmax(cluster_inner * 2.0, dim=-1)
        return result
