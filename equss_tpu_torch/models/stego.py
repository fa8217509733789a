"""STEGO baseline: frozen DINO ViT -> low-dimensional head, trained with
the STEGO correspondence loss alone.

Counterpart of ``equss_tpu/models/stego.py`` (``STEGOConfig`` with
``from_config``, ``STEGOModel``): the EQUSS pipeline without the
quantizer, its expansion head projecting to ``dim`` (70 by default).  The
supervised ``sl`` model is the same module, trained by the trainer's
supervised mode.  NHWC throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from equss_tpu_torch.device import DeviceLike, resolve_device
from equss_tpu_torch.losses.stego import StegoLossConfig, stego_loss
from equss_tpu_torch.models.equss import backbone_settings, stego_config_from_dict
from equss_tpu_torch.models.heads import ExpansionHead, dropout2d
from equss_tpu_torch.models.vit import VisionTransformer, make_vit_config


@dataclasses.dataclass(frozen=True)
class STEGOConfig:
    model_type: str = "vit_small"
    patch_size: int = 8
    dim: int = 70
    dropout: bool = True
    drop_prob: float = 0.1
    backbone_dtype: torch.dtype = torch.float32
    attn_bf16: bool = False
    gelu: Any = None                 # None (auto) | 'erf' | 'tanh'
    fused_ln: bool = False           # ViTConfig.fused_ln (no YAML key)
    ln_stats: str = "f32"            # 'f32' | 'bf16' (BF16StatsLayerNorm)
    stego: StegoLossConfig = dataclasses.field(default_factory=StegoLossConfig)

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "STEGOConfig":
        """The model part of a config dict, as the JAX package reads it:
        the loss knobs from ``loss.stego``, or from ``loss`` itself where a
        config puts them there (the reference's stego.yaml); a config
        without them (``sl``) takes the defaults."""
        pre = cfg["model"]["pretrained"]
        loss_cfg = cfg["loss"].get("stego", cfg["loss"])
        return STEGOConfig(
            dim=pre.get("dim", 70),
            dropout=pre.get("dropout", True),
            drop_prob=pre.get("drop_prob", 0.1),
            stego=stego_config_from_dict(loss_cfg),
            **backbone_settings(pre))


class STEGOModel(nn.Module):
    """The STEGO model: ``backbone`` (frozen) and ``head``; no state.
    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and moved to ``device`` (None means CUDA, which must then be present)."""

    def __init__(self, cfg: STEGOConfig, *, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.vit_cfg = make_vit_config(cfg.model_type, cfg.patch_size, dtype=cfg.backbone_dtype,
                                       attn_bf16=cfg.attn_bf16, gelu=cfg.gelu,
                                       fused_ln=cfg.fused_ln, ln_stats=cfg.ln_stats)
        self.backbone = VisionTransformer(self.vit_cfg, device=self.device, generator=generator)
        self.backbone.requires_grad_(False)          # frozen
        self.feat_dim = self.vit_cfg.embed_dim
        self.head = ExpansionHead(self.feat_dim, cfg.dim, generator)
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        return self.cfg.dim

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """Frozen backbone dense features (b, gh, gw, C) in f32."""
        with torch.no_grad():
            return self.backbone(img)["dense"].float()

    def forward(self, img: Optional[torch.Tensor] = None,
                img_pos: Optional[torch.Tensor] = None, *,
                feat: Optional[torch.Tensor] = None,
                feat_pos: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                stego_override: Optional[Tuple] = None) -> Dict[str, Any]:
        """The counterpart of ``STEGOModel.apply``: images (or cached dense
        features) -> ``feat`` and ``code`` (b, gh, gw, dim), and ``aux``.

        Inference runs without autograd and ``aux`` is empty.  Training
        takes the kNN positives: one backbone pass over ``[img; img_pos]``,
        channel dropout drawn from ``generator``, the head on both halves
        and the STEGO loss (``aux['stego-loss']``; ``stego_override`` =
        ``(coords1, coords2, perms)`` replaces its random draws)."""
        if not training:
            with torch.no_grad():
                if feat is None:
                    if img is None:
                        raise ValueError("forward needs img or feat")
                    feat = self.features(img)
                return {"feat": feat, "code": self.head(feat), "aux": {}}
        cfg = self.cfg
        if feat is not None:
            if feat_pos is None:
                raise ValueError("cached-feature training requires feat_pos")
            b = feat.shape[0]
            both = torch.cat([feat, feat_pos], 0)
        else:
            if img is None or img_pos is None:
                raise ValueError("training forward requires img and img_pos (kNN positive)")
            b = img.shape[0]
            both = self.features(torch.cat([img, img_pos], 0))
        if cfg.dropout:
            if generator is None:
                raise ValueError("training with dropout requires a generator")
            both = dropout2d(generator, both, cfg.drop_prob, parts=2)
        code_both = self.head(both)
        feat, feat_pos = both[:b], both[b:]
        code, code_pos = code_both[:b], code_both[b:]
        aux = {"stego-loss": stego_loss(generator, feat, feat_pos, code, code_pos, cfg.stego,
                                        sample_override=stego_override)}
        return {"feat": feat, "code": code, "aux": aux}
