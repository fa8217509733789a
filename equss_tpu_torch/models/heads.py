"""Projection heads, residual blocks and channel dropout.

Counterpart of ``equss_tpu/models/heads.py``: ``ExpansionHead`` (also
``SegmentationHead``), ``dropout2d``, the two residual block libraries
of the reference (``EncResBlock`` / ``DecResBlock`` / ``ResBlock``, and
the linear flavour ``LinEncResBlock`` / ``LinDecResBlock`` /
``ReLUResBlock``), ``Conv2d``, ``ConvTranspose2dTorch`` and
``CLUBEncoder``.  NHWC: the 1x1 convolutions are Dense layers over the
channel axis, in f32.  Parameter names are flax's, so ``convert`` maps
weights one to one.

``BatchNorm`` follows flax, not torch: the batch's biased variance as
E[x^2] - E[x]^2 (clipped at 0), momentum 0.9 on the running averages,
and the running variance updated with the biased variance.  In a global
program (``parallel.mesh``) the statistics are the global batch's: the
ranks' means of x and x^2 averaged over the ranks, as flax's
``axis_name`` does.  The running
averages are buffers that the forward never writes: a training call
records their new values in the ``updates`` dict it is given (module ->
(mean, var)), and the model hands them to the trainer, which commits
them after a finite step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equss_tpu_torch.models.vit import Dense, _trunc_normal
from equss_tpu_torch.parallel import mesh


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


SegmentationHead = ExpansionHead

BNUpdates = Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]]


def dropout2d(generator: torch.Generator, x: torch.Tensor, rate: float,
              parts: int = 1) -> torch.Tensor:
    """Channel dropout (torch ``nn.Dropout2d``) for NHWC: zeroes whole
    channels per sample and scales the survivors by 1/(1-p).  The keep
    mask is drawn from ``generator``, which must live on ``x``'s device.
    In a global program the mask is drawn for the global batch and each
    rank keeps its rows (``parallel.mesh.global_rows``; ``parts``: the
    batch blocks stacked in ``x``, as ``[img; img_pos]`` is 2)."""
    if rate <= 0.0:
        return x
    b, _, _, c = x.shape
    keep = mesh.global_rows(
        lambda n: torch.rand((n, 1, 1, c), generator=generator, device=x.device),
        b, parts) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def as_state(module: nn.Module) -> nn.Module:
    """Turn every parameter of ``module`` into a buffer of the same name:
    weights that a model keeps as state (an EMA teacher, the CLUB encoder
    and its Adam moments), which the state dict and checkpoints carry and
    no optimizer of the model's parameters picks up."""
    for m in module.modules():
        for name, p in list(m._parameters.items()):
            del m._parameters[name]
            if p is not None:
                m.register_buffer(name, p.detach())
    return module


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (eps 1e-5, momentum 0.9):
    ``weight`` (scale), ``bias``; running ``mean`` and ``var`` buffers."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool,
                updates: Optional[BNUpdates] = None) -> torch.Tensor:
        if train:
            axes = tuple(range(x.ndim - 1))
            mean, mean_sq = x.mean(axes), (x * x).mean(axes)
            if mesh.in_program():
                mean, mean_sq = mesh.mean_over_ranks(torch.stack([mean, mean_sq])).unbind(0)
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            if updates is not None:
                m = self.momentum
                updates[self] = (m * self.mean + (1 - m) * mean.detach(),
                                 m * self.var + (1 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class EncResBlock(nn.Module):
    """Residual 1x1-conv MLP with identity norms (blocks/module.py):
    conv1 (c_in) -> ReLU -> conv2 (out), Dense shortcut where the widths
    differ."""

    def __init__(self, c_in: int, out: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = Dense(c_in, c_in, generator)
        self.conv2 = Dense(c_in, out, generator)
        self.conv_shortcut = Dense(c_in, out, generator) if c_in != out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        h = self.conv2(torch.relu(self.conv1(x, f32)), f32)
        return h + (x if self.conv_shortcut is None else self.conv_shortcut(x, f32))


class DecResBlock(nn.Module):
    """Residual block with BatchNorm (blocks/module.py): BN -> conv1 (no
    bias) -> BN -> LeakyReLU(0.1) -> conv2; BN + biasless Dense shortcut
    where the widths differ."""

    def __init__(self, c_in: int, out: int, generator: torch.Generator):
        super().__init__()
        self.norm1 = BatchNorm(c_in)
        self.conv1 = Dense(c_in, out, generator, bias=False)
        self.norm2 = BatchNorm(out)
        self.conv2 = Dense(out, out, generator)
        if c_in != out:
            self.norm_shortcut = BatchNorm(c_in)
            self.conv_shortcut = Dense(c_in, out, generator, bias=False)
        else:
            self.norm_shortcut = self.conv_shortcut = None

    def forward(self, x: torch.Tensor, train: bool = True,
                updates: Optional[BNUpdates] = None) -> torch.Tensor:
        f32 = torch.float32
        h = self.conv1(self.norm1(x, train, updates), f32)
        h = F.leaky_relu(self.norm2(h, train, updates), 0.1)
        h = self.conv2(h, f32)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(self.norm_shortcut(x, train, updates), f32)
        return h + x


class Conv2d(nn.Module):
    """flax ``nn.Conv(out, (k, k), strides=stride, padding=padding)`` on
    NHWC input in f32: ``weight (out, in, k, k)``, ``bias (out,)``;
    initialised as flax's lecun-normal kernel (fan-in k^2 in) and zero
    bias."""

    def __init__(self, c_in: int, out: int, generator: torch.Generator, k: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        std = math.sqrt(1.0 / (k * k * c_in)) / 0.87962566103423978
        self.weight = nn.Parameter(_trunc_normal((out, c_in, k, k), std, generator))
        self.bias = nn.Parameter(torch.zeros(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.float().permute(0, 3, 1, 2), self.weight, self.bias,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2dTorch(nn.Module):
    """torch ``nn.ConvTranspose2d(in, out, 4, stride=2, padding=1)`` on NHWC
    input in f32, which doubles H and W: ``weight (in, out, 4, 4)``,
    ``bias (out,)``.  The JAX module keeps its kernel as (kh, kw, out, in)
    and applies it as a correlation over the stride-dilated input, which
    is this transposed convolution with the kernel flipped in both spatial
    axes: ``convert`` flips it on the way in.  Initialised as the JAX
    module's lecun-normal kernel (fan-in 16 out) and zero bias."""

    def __init__(self, c_in: int, out: int, generator: torch.Generator, k: int = 4,
                 stride: int = 2, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        std = math.sqrt(1.0 / (k * k * out)) / 0.87962566103423978
        self.weight = nn.Parameter(_trunc_normal((c_in, out, k, k), std, generator))
        self.bias = nn.Parameter(torch.zeros(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.float().permute(0, 3, 1, 2), self.weight, self.bias,
                               stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    """blocks/module.py's ResBlock: LeakyReLU(0.1) -> 3x3 conv (channels)
    -> LeakyReLU(0.1) -> 1x1 back to c_in, plus the input.  No variant
    calls it."""

    def __init__(self, c_in: int, channels: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = Conv2d(c_in, channels, generator)
        self.conv2 = Dense(channels, c_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.leaky_relu(x, 0.1))
        return self.conv2(F.leaky_relu(h, 0.1), torch.float32) + x


class LinEncResBlock(nn.Module):
    """blocks/resnet_linear.py's EncResBlock: ReLU -> conv1 (out) -> ReLU
    -> conv2 (out), Dense shortcut where the widths differ."""

    def __init__(self, c_in: int, out: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = Dense(c_in, out, generator)
        self.conv2 = Dense(out, out, generator)
        self.conv_shortcut = Dense(c_in, out, generator) if c_in != out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        h = self.conv2(torch.relu(self.conv1(torch.relu(x), f32)), f32)
        return h + (x if self.conv_shortcut is None else self.conv_shortcut(x, f32))


class LinDecResBlock(nn.Module):
    """blocks/resnet_linear.py's DecResBlock: BN -> LeakyReLU(0.1) -> conv1
    -> BN -> LeakyReLU -> conv2, both Dense with bias; BN + Dense
    shortcut where the widths differ."""

    def __init__(self, c_in: int, out: int, generator: torch.Generator):
        super().__init__()
        self.norm1 = BatchNorm(c_in)
        self.conv1 = Dense(c_in, out, generator)
        self.norm2 = BatchNorm(out)
        self.conv2 = Dense(out, out, generator)
        if c_in != out:
            self.norm_shortcut = BatchNorm(c_in)
            self.conv_shortcut = Dense(c_in, out, generator)
        else:
            self.norm_shortcut = self.conv_shortcut = None

    def forward(self, x: torch.Tensor, train: bool = True,
                updates: Optional[BNUpdates] = None) -> torch.Tensor:
        f32 = torch.float32
        h = self.conv1(F.leaky_relu(self.norm1(x, train, updates), 0.1), f32)
        h = self.conv2(F.leaky_relu(self.norm2(h, train, updates), 0.1), f32)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(self.norm_shortcut(x, train, updates), f32)
        return h + x


class ReLUResBlock(nn.Module):
    """blocks/resnet_linear.py's ResBlock (the VAE decoder's): ReLU -> 3x3
    conv (channels) -> ReLU -> 1x1 back to c_in, plus relu(x): the
    reference's in-place first ReLU rectifies the input it adds back."""

    def __init__(self, c_in: int, channels: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = Conv2d(c_in, channels, generator)
        self.conv2 = Dense(channels, c_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.relu(x.float())
        h = torch.relu(self.conv1(r))
        return self.conv2(h, torch.float32) + r


class CLUBEncoder(nn.Module):
    """Variational encoder of the CLUB bound: ``p_mu`` a 5-Dense ReLU MLP
    and ``p_logvar`` a 6-Dense one at hidden_dim // 2, and a Dense
    residual of the input added to the log-variance.  ``forward(x,
    residual)`` -> (mu, logvar), both (bhw, out_dim); ``residual=False``
    is the path the inner likelihood trains."""

    def __init__(self, d_in: int, hidden_dim: int, out_dim: int,
                 generator: torch.Generator):
        super().__init__()
        half = hidden_dim // 2
        for name, n_hidden in (("p_mu", 4), ("p_logvar", 5)):
            for i in range(n_hidden):
                setattr(self, f"{name}_fc{i}", Dense(d_in if i == 0 else half, half, generator))
            setattr(self, f"{name}_out", Dense(half, out_dim, generator))
        self.p_residual = Dense(d_in, out_dim, generator)

    def _mlp(self, name: str, n_hidden: int, h: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        for i in range(n_hidden):
            h = torch.relu(getattr(self, f"{name}_fc{i}")(h, f32))
        return getattr(self, f"{name}_out")(h, f32)

    def forward(self, x: torch.Tensor, residual: bool = True):
        flat = x.reshape(-1, x.shape[-1])
        p_mu = self._mlp("p_mu", 4, flat)
        p_logvar = self._mlp("p_logvar", 5, flat)
        if residual:
            p_logvar = p_logvar + self.p_residual(flat, torch.float32)
        return p_mu, p_logvar
