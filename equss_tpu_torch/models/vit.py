"""DINO Vision Transformer in PyTorch.

Counterpart of ``equss_tpu/models/vit.py``: patch embedding, CLS token,
bicubic pos-embed interpolation with the +0.1 fudge, pre-LN blocks with
qkv-bias attention, NHWC images in and (b, gh, gw, C) dense features out.

Numerics follow the JAX package:
* ``dtype`` is the compute dtype; parameters stay f32 and every Dense
  casts its input and weights to ``dtype`` (flax ``Dense(dtype=...)``).
* LayerNorm takes f32 statistics (eps 1e-6) and returns ``dtype``.
* GELU is tanh-approximated in bf16 and exact erf in f32, unless
  ``gelu_tanh`` says otherwise.
* The patch embedding is a reshape and a matmul, exact for stride =
  kernel and free of cuDNN's TF32 convolution.
* Attention runs the fused kernel (``ops/attention.py``) when
  ``attn_bf16`` holds, the dtype is bf16 and the token count is at least
  ``fused_attn_min_n``; otherwise plain matmuls with f32 logits (bf16
  logits in ``attn_bf16`` mode).  The kernel masks keys by count, so the
  token stream is not padded.
* ``fused_ln`` (bf16 only, off by default) puts every LayerNorm on the
  kernels of ``ops/layernorm.py``: each block's residual adds ride inside
  the add + LayerNorm kernel, and the MLP output travels as a pending
  residual into the next block's norm1 or the final norm.  The parameter
  names do not change, so the same weights load either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from equss_tpu_torch.device import DeviceLike, resolve_device
from equss_tpu_torch.ops.attention import attention_qkv
from equss_tpu_torch.ops.layernorm import fused_add_layernorm, fused_layernorm
from equss_tpu_torch.ops.resize import resize2d


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 8
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    pos_grid: int = 28            # sqrt(num_patches) the pos-embed was trained at
    dtype: torch.dtype = torch.float32
    attn_bf16: bool = False
    fused_attn_min_n: int = 512
    gelu_tanh: Any = None         # None: tanh in bf16, erf in f32
    fused_ln: bool = False        # LayerNorm kernels in bf16 (use_fused_ln)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def gelu_approximate(self) -> bool:
        if self.gelu_tanh is None:
            return self.dtype == torch.bfloat16
        return bool(self.gelu_tanh)


VIT_PRESETS = {
    # (embed_dim, depth, num_heads)
    "vit_tiny": (192, 12, 3),
    "vit_small": (384, 12, 6),
    "vit_base": (768, 12, 12),
    "vit_micro": (32, 2, 2),      # tests only
}


def make_vit_config(model_type: str, patch_size: int,
                    dtype: torch.dtype = torch.float32, img_size: int = 224,
                    attn_bf16: bool = False, gelu: Any = None,
                    fused_ln: bool = False) -> ViTConfig:
    """gelu: None (auto), 'erf'/False or 'tanh'/True."""
    if model_type not in VIT_PRESETS:
        raise ValueError(f"Unknown arch {model_type}")
    dim, depth, heads = VIT_PRESETS[model_type]
    if isinstance(gelu, str):
        if gelu not in ("erf", "tanh"):
            raise ValueError(f"model.pretrained.gelu must be erf|tanh, got {gelu}")
        gelu = gelu == "tanh"
    return ViTConfig(patch_size=patch_size, embed_dim=dim, depth=depth,
                     num_heads=heads, pos_grid=img_size // patch_size,
                     dtype=dtype, attn_bf16=attn_bf16, gelu_tanh=gelu,
                     fused_ln=fused_ln)


def use_fused_ln(cfg: ViTConfig) -> bool:
    """The one gate for both the LayerNorm kind and the pending-residual
    threading of ``Block``: the threading is valid only where every norm
    is a ``FusedLayerNorm``."""
    return cfg.fused_ln and cfg.dtype == torch.bfloat16


def _trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    return t


class Dense(nn.Module):
    """``weight (out, in)``, ``bias (out,)`` in f32; the product runs in
    the dtype of the call (input and weights cast to it).  Initialised
    as flax's lecun-normal kernel and zero bias."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator,
                 bias: bool = True):
        super().__init__()
        std = math.sqrt(1.0 / d_in) / 0.87962566103423978
        self.weight = nn.Parameter(_trunc_normal((d_out, d_in), std, generator))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), b)


class LayerNorm(nn.LayerNorm):
    """f32 statistics and affine, output in the dtype of the call."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(dtype)


class FusedLayerNorm(nn.Module):
    """LayerNorm on the kernels of ``ops/layernorm.py``, with the
    parameter names of ``LayerNorm`` (``weight``, ``bias``, f32).  Called
    with a second operand it fuses the residual add: ``(x, y) -> (x + y,
    LN(x + y))``.  Operands must be of the compute dtype: the kernels take
    bf16 and f32 statistics, and a silent cast would round a wider stream
    before its statistics."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None):
        for name, v in (("x", x), ("y", y)):
            if v is not None and v.dtype != self.dtype:
                raise TypeError(f"FusedLayerNorm({self.dtype}) got {name} of dtype "
                                f"{v.dtype}; cast explicitly")
        if y is None:
            return fused_layernorm(x, self.weight, self.bias, self.eps)
        return fused_add_layernorm(x, y, self.weight, self.bias, self.eps)


def _make_norm(cfg: ViTConfig) -> nn.Module:
    if use_fused_ln(cfg):
        return FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, cfg.dtype)
    return LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.qkv = Dense(C, 3 * C, generator, bias=cfg.qkv_bias)
        self.proj = Dense(C, C, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, N, C = x.shape
        qkv = self.qkv(x, cfg.dtype)                           # (B, N, 3C)
        scale = cfg.head_dim ** -0.5
        if N >= cfg.fused_attn_min_n and cfg.attn_bf16 and cfg.dtype == torch.bfloat16:
            out = attention_qkv(qkv, cfg.num_heads, scale)
        else:
            q, k, v = qkv.reshape(B, N, 3, cfg.num_heads, cfg.head_dim).unbind(2)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, N, hd)
            if cfg.attn_bf16 and cfg.dtype == torch.bfloat16:
                logits = torch.matmul(q, k.transpose(-1, -2)) * scale
            else:
                logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            attn = torch.softmax(logits, dim=-1)
            out = torch.matmul(attn.to(cfg.dtype), v).to(cfg.dtype)
            out = out.transpose(1, 2).reshape(B, N, C)
        return self.proj(out, cfg.dtype)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = Dense(cfg.embed_dim, hidden, generator)
        self.fc2 = Dense(hidden, cfg.embed_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = F.gelu(self.fc1(x, cfg.dtype),
                   approximate="tanh" if cfg.gelu_approximate else "none")
        return self.fc2(h, cfg.dtype)


class Block(nn.Module):
    """Returns ``(x, pending)``.  Under ``use_fused_ln`` the MLP output is
    the pending residual that the next block's norm1 (or the final norm)
    adds inside its add + LayerNorm kernel; on the stock path the adds
    happen here and pending is None."""

    def __init__(self, cfg: ViTConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.fused_ln = use_fused_ln(cfg)
        self.norm1 = _make_norm(cfg)
        self.attn = Attention(cfg, generator)
        self.norm2 = _make_norm(cfg)
        self.mlp = Mlp(cfg, generator)

    def forward(self, x: torch.Tensor, pending: Optional[torch.Tensor] = None):
        if self.fused_ln:
            if pending is None:
                h1 = self.norm1(x)
            else:
                x, h1 = self.norm1(x, pending)
            x, h2 = self.norm2(x, self.attn(h1))
            return x, self.mlp(h2)
        x = x + self.attn(self.norm1(x, self.cfg.dtype))
        return x + self.mlp(self.norm2(x, self.cfg.dtype)), None


class VisionTransformer(nn.Module):
    """DINO ViT.  ``forward(img)`` with img (b, H, W, 3) NHWC, H and W
    divisible by the patch size -> dict with ``dense`` (b, gh, gw, C),
    ``cls`` (b, C) and ``tokens`` (b, 1 + gh*gw, C), after the final norm.

    Weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given) and then moved to ``device``: ``None`` means CUDA, which must
    then be present."""

    def __init__(self, cfg: ViTConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        C, p = cfg.embed_dim, cfg.patch_size
        # patch conv as a matmul over (kh, kw, in)-ordered patch vectors
        self.patch_embed = Dense(p * p * 3, C, generator)
        self.cls_token = nn.Parameter(_trunc_normal((1, 1, C), 0.02, generator))
        self.pos_embed = nn.Parameter(
            _trunc_normal((1, cfg.pos_grid ** 2 + 1, C), 0.02, generator))
        self.blocks = nn.ModuleList(Block(cfg, generator) for _ in range(cfg.depth))
        self.norm = _make_norm(cfg)
        self.to(device)

    def _interpolate_pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """Bicubic interpolation with the DINO +0.1 scale fudge."""
        pos_embed = self.pos_embed
        g0 = int(math.sqrt(pos_embed.shape[1] - 1))
        if gh == g0 and gw == g0:
            return pos_embed
        patch_pe = pos_embed[:, 1:].reshape(1, g0, g0, -1)
        sf = ((gh + 0.1) / g0, (gw + 0.1) / g0)
        patch_pe = resize2d(patch_pe, (gh, gw), method="bicubic", scale_factor=sf)
        return torch.cat([pos_embed[:, :1], patch_pe.reshape(1, gh * gw, -1)], 1)

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b, H, W, _ = img.shape
        p = cfg.patch_size
        gh, gw = H // p, W // p
        patches = (img.to(cfg.dtype).reshape(b, gh, p, gw, p, 3)
                   .permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3))
        x = self.patch_embed(patches, cfg.dtype)
        cls = self.cls_token.to(cfg.dtype).expand(b, 1, cfg.embed_dim)
        x = torch.cat([cls, x], 1)
        x = x + self._interpolate_pos_embed(gh, gw).to(cfg.dtype)

        pending = None
        for blk in self.blocks:
            x, pending = blk(x, pending)
        if pending is None:
            tokens = self.norm(x, cfg.dtype)
        else:   # only under use_fused_ln, where the final norm is fused too
            tokens = self.norm(x, pending)[1]
        return {
            "dense": tokens[:, 1:].reshape(b, gh, gw, cfg.embed_dim),
            "cls": tokens[:, 0],
            "tokens": tokens,
        }
