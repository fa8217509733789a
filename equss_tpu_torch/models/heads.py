"""The EQUSS expansion head and channel dropout.

Counterpart of ``equss_tpu/models/heads.py::ExpansionHead`` and
``dropout2d``.  NHWC: the 1x1 convolutions are Dense layers over the
channel axis.
"""
from __future__ import annotations

import torch
from torch import nn

from equss_tpu_torch.models.vit import Dense


class ExpansionHead(nn.Module):
    """cluster1 (linear) + cluster2 (linear-ReLU-linear), summed, in f32:
    projects (..., d_in) frozen features to (..., hidden_dim)."""

    def __init__(self, d_in: int, hidden_dim: int, generator: torch.Generator):
        super().__init__()
        self.cluster1 = Dense(d_in, hidden_dim, generator)
        self.cluster2_fc1 = Dense(d_in, d_in, generator)
        self.cluster2_fc2 = Dense(d_in, hidden_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        h = torch.relu(self.cluster2_fc1(x, f32))
        return self.cluster1(x, f32) + self.cluster2_fc2(h, f32)


def dropout2d(generator: torch.Generator, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Channel dropout (torch ``nn.Dropout2d``) for NHWC: zeroes whole
    channels per sample and scales the survivors by 1/(1-p).  The keep
    mask is drawn from ``generator``, which must live on ``x``'s device."""
    if rate <= 0.0:
        return x
    b, _, _, c = x.shape
    keep = torch.rand((b, 1, 1, c), generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
