"""EQUSS: frozen DINO ViT -> expansion head -> product quantization.

Counterpart of ``equss_tpu/models/equss.py`` (``EQUSSConfig`` and the
inference branch of ``EQUSS.init/features/encode/apply``).  The model is an
``nn.Module`` holding the backbone, the head, the quantizer parameters
(``pq.*``) and its state (``pq_state.*``); ``convert.params_from_jax``
maps the JAX package's pytrees onto the same names.  NHWC throughout:
images (b, H, W, 3) already normalised (``data.transforms``), features
(b, gh, gw, C).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from equss_tpu_torch.device import DeviceLike, resolve_device
from equss_tpu_torch.models.heads import ExpansionHead
from equss_tpu_torch.models.vit import VisionTransformer, make_vit_config
from equss_tpu_torch.ops.quantizer import PQConfig, pq_forward, pq_init


@dataclasses.dataclass(frozen=True)
class EQUSSConfig:
    model_type: str = "vit_small"
    patch_size: int = 8
    hidden_dim: int = 1024
    backbone_dtype: torch.dtype = torch.float32
    attn_bf16: bool = False
    gelu: Any = None                 # None (auto) | 'erf' | 'tanh'
    pq: PQConfig = dataclasses.field(default_factory=PQConfig)


class _Buffers(nn.Module):
    """Named tensors that move with the model and sit in its state dict
    but are not parameters (the quantizer state)."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())


class EQUSS(nn.Module):
    """The EQUSS model, inference path.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and then moved to ``device``: ``None`` means CUDA, which must then be
    present; pass ``device='cpu'`` to run on the CPU."""

    def __init__(self, cfg: EQUSSConfig, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.vit_cfg = make_vit_config(
            cfg.model_type, cfg.patch_size, dtype=cfg.backbone_dtype,
            attn_bf16=cfg.attn_bf16, gelu=cfg.gelu)
        self.backbone = VisionTransformer(self.vit_cfg, device=self.device,
                                          generator=generator)
        self.feat_dim = self.vit_cfg.embed_dim
        self.head = ExpansionHead(self.feat_dim, cfg.hidden_dim, generator)
        pq_params, pq_state = pq_init(generator, cfg.pq)
        self.pq = nn.ParameterDict(pq_params)
        self.pq_state = _Buffers(pq_state)
        self.to(self.device)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """Frozen backbone dense features (b, gh, gw, C) in f32."""
        return self.backbone(img)["dense"].float()

    def encode(self, feat: torch.Tensor) -> torch.Tensor:
        """Expansion head: (b, gh, gw, C) -> (b, gh, gw, hidden_dim)."""
        return self.head(feat)

    @torch.no_grad()
    def forward(self, img: Optional[torch.Tensor] = None, *,
                feat: Optional[torch.Tensor] = None,
                training: bool = False) -> Dict[str, Any]:
        """Inference forward, the counterpart of ``EQUSS.apply(training=False)``:
        images (or cached dense features) -> ``feat``, ``code``, ``z_q``
        (b, gh, gw, hidden_dim), ``indices`` (b, gh, gw, M) int32 and
        ``aux`` (``vq-loss``, ``codebook-sum``)."""
        if training:
            raise NotImplementedError(
                "EQUSS training (STEGO loss, codebook updates) belongs to the "
                "train-step slice of the port")
        if feat is None:
            if img is None:
                raise ValueError("forward needs img or feat")
            feat = self.features(img)
        code = self.encode(feat)
        z_q, indices, aux, _ = pq_forward(
            code, dict(self.pq), self.pq_state.as_dict(), self.cfg.pq)
        return {"feat": feat, "code": code, "z_q": z_q, "indices": indices,
                "aux": aux}
