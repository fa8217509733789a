"""Probe-only baseline: frozen DINO features straight into the probes.

Counterpart of ``equss_tpu/models/probe_only.py`` (``ProbeOnlyConfig``,
``ProbeOnlyModel``): no head and no quantizer, so the model has no
trainable parameter; only the evaluator's probes train, on the frozen
dense features.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from equss_tpu_torch.device import DeviceLike, resolve_device
from equss_tpu_torch.models.equss import backbone_settings
from equss_tpu_torch.models.vit import VisionTransformer, make_vit_config


@dataclasses.dataclass(frozen=True)
class ProbeOnlyConfig:
    model_type: str = "vit_small"
    patch_size: int = 8
    backbone_dtype: torch.dtype = torch.float32
    attn_bf16: bool = False
    gelu: Any = None                 # None (auto) | 'erf' | 'tanh'
    fused_ln: bool = False           # ViTConfig.fused_ln (no YAML key)
    ln_stats: str = "f32"            # 'f32' | 'bf16' (BF16StatsLayerNorm)

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "ProbeOnlyConfig":
        return ProbeOnlyConfig(**backbone_settings(cfg["model"]["pretrained"]))


class ProbeOnlyModel(nn.Module):
    """The frozen backbone alone; ``code`` is its dense features.  Weights
    are drawn on the CPU from ``torch.Generator().manual_seed(seed)`` and
    moved to ``device`` (None means CUDA, which must then be present)."""

    def __init__(self, cfg: ProbeOnlyConfig, *, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vit_cfg = make_vit_config(cfg.model_type, cfg.patch_size, dtype=cfg.backbone_dtype,
                                       attn_bf16=cfg.attn_bf16, gelu=cfg.gelu,
                                       fused_ln=cfg.fused_ln, ln_stats=cfg.ln_stats)
        self.backbone = VisionTransformer(self.vit_cfg, device=self.device,
                                          generator=torch.Generator().manual_seed(seed))
        self.backbone.requires_grad_(False)          # frozen
        self.feat_dim = self.vit_cfg.embed_dim
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        return self.feat_dim

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """Frozen backbone dense features (b, gh, gw, C) in f32."""
        with torch.no_grad():
            return self.backbone(img)["dense"].float()

    def forward(self, img: Optional[torch.Tensor] = None,
                img_pos: Optional[torch.Tensor] = None, *,
                feat: Optional[torch.Tensor] = None, training: bool = False,
                **_: Any) -> Dict[str, Any]:
        """``feat`` and ``code`` (both the frozen features) and an empty
        ``aux``, in training as in inference (the positives go unused)."""
        if feat is None:
            if img is None:
                raise ValueError("forward needs img or feat")
            feat = self.features(img)
        return {"feat": feat, "code": feat, "aux": {}}
