"""EQUSS: frozen DINO ViT -> expansion head -> product quantization.

Counterpart of ``equss_tpu/models/equss.py`` (``pq_config_from_dict``,
``stego_config_from_dict``, ``EQUSSConfig`` with ``from_config``, and
``EQUSS.init/features/encode/data_init/apply``).  The model is an ``nn.Module``
holding the backbone, the head, the quantizer parameters (``pq.*``) and
its state (``pq_state.*``); ``convert.params_from_jax`` maps the JAX
package's pytrees onto the same names.  NHWC throughout: images (b, H, W,
3) already normalised (``data.transforms``), features (b, gh, gw, C).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from equss_tpu_torch.device import DeviceLike, resolve_device
from equss_tpu_torch.losses.stego import StegoLossConfig, stego_loss
from equss_tpu_torch.models.heads import ExpansionHead, dropout2d
from equss_tpu_torch.models.vit import VisionTransformer, make_vit_config
from equss_tpu_torch.ops.quantizer import (PQConfig, ema_jsd_entropy, needs_data_init,
                                           pq_data_init, pq_forward, pq_init)
from equss_tpu_torch.parallel import mesh


def pq_config_from_dict(vq: Dict[str, Any]) -> PQConfig:
    """cfg['model']['vq'] -> PQConfig."""
    num_pq = vq.get("num_pq", 1)
    if isinstance(num_pq, (list, tuple)):
        num_pq = num_pq[0]
    return PQConfig(
        num_pq=num_pq,
        num_codebook=vq["num_codebooks"][0],
        embed_dim=vq["embed_dims"][0],
        vq_type=vq.get("vq_type", "param"),
        beta=vq.get("beta", 0.25),
        book=vq.get("book", 1.0),
        normalize=vq.get("normalize", "none"),
        use_weighted_sum=vq.get("use_weighted_sum", False),
        use_gumbel=vq.get("use_gumbel", False),
        use_restart=vq.get("use_restart", False),
        use_split=vq.get("use_split", False),
        need_initialized=vq.get("need_initialized", "none"),
        pq_dropout=vq.get("pq_dropout", 0.0),
        decay=vq.get("decay", 0.99),
        eps=vq.get("eps", 1e-5),
        jsd_ts=vq.get("jsd_ts", 1.0),
        use_pallas=vq.get("use_pallas", "auto"),
        assign_precision=vq.get("assign_precision", "exact"),
    )


def stego_config_from_dict(stego: Dict[str, Any]) -> StegoLossConfig:
    """cfg['loss']['stego'] -> StegoLossConfig (defaults where omitted)."""
    defaults = dataclasses.asdict(StegoLossConfig())
    return StegoLossConfig(**{k: stego.get(k, v) for k, v in defaults.items()})


def backbone_settings(pre: Dict[str, Any]) -> Dict[str, Any]:
    """``cfg['model']['pretrained']`` -> the backbone fields every model
    config shares, as the JAX package reads them:
    ``precision: bf16`` selects the bf16 backbone with bf16 attention, and
    ``ln_stats`` (``f32`` or ``bf16``) its LayerNorm statistics.
    ``freeze_backbone`` changes nothing that trains (the backbone is never
    among the trained parameters), so the port always runs the backbone
    without autograd."""
    bf16 = pre.get("precision", "f32") == "bf16"
    return dict(model_type=pre["model_type"], patch_size=pre["dino_patch_size"],
                backbone_dtype=torch.bfloat16 if bf16 else torch.float32,
                attn_bf16=bf16, gelu=pre.get("gelu"), ln_stats=pre.get("ln_stats", "f32"))


@dataclasses.dataclass(frozen=True)
class EQUSSConfig:
    model_type: str = "vit_small"
    patch_size: int = 8
    hidden_dim: int = 1024
    dropout: bool = True
    drop_prob: float = 0.1
    backbone_dtype: torch.dtype = torch.float32
    attn_bf16: bool = False
    gelu: Any = None                 # None (auto) | 'erf' | 'tanh'
    fused_ln: bool = False           # ViTConfig.fused_ln (no YAML key)
    ln_stats: str = "f32"            # 'f32' | 'bf16' (BF16StatsLayerNorm)
    pq: PQConfig = dataclasses.field(default_factory=PQConfig)
    stego: StegoLossConfig = dataclasses.field(default_factory=StegoLossConfig)

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "EQUSSConfig":
        """The model part of a config dict, as the JAX package reads it
        (``backbone_settings`` for the backbone)."""
        m = cfg["model"]
        pre = m["pretrained"]
        return EQUSSConfig(
            hidden_dim=m["vq"]["embed_dims"][0],
            dropout=pre.get("dropout", True),
            drop_prob=pre.get("drop_prob", 0.1),
            pq=pq_config_from_dict(m["vq"]),
            stego=stego_config_from_dict(cfg["loss"]["stego"]),
            **backbone_settings(pre))


def pq_data_init_named(zf: torch.Tensor, params: Dict[str, torch.Tensor],
                       state: Dict[str, torch.Tensor], cfg: PQConfig,
                       generator: Optional[torch.Generator], draws: Dict[str, Any], i: int,
                       params_prefix: str, state_prefix: str):
    """``pq_data_init`` of quantizer ``i`` of a model, its draws
    ``kmeans_first_<i>``, ``kmeans_gumbel_<i>`` and ``rand_idx_<i>`` from
    ``draws`` where given.  Returns (the new tensors by the model's
    parameter and buffer names, the new params, the new state)."""
    p, s = pq_data_init(zf, params, state, cfg, generator,
                        first=draws.get(f"kmeans_first_{i}"),
                        gumbel_noise=draws.get(f"kmeans_gumbel_{i}"),
                        rand_idx=draws.get(f"rand_idx_{i}"))
    if cfg.vq_type == "param":
        new = {f"{params_prefix}codebook": p["codebook"]}
    else:
        new = {f"{state_prefix}{k}": s[k] for k in ("ema_weight", "ema_weight_avg")}
    return new, p, s


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
    """The EQUSS model.

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
            attn_bf16=cfg.attn_bf16, gelu=cfg.gelu, fused_ln=cfg.fused_ln,
            ln_stats=cfg.ln_stats)
        self.backbone = VisionTransformer(self.vit_cfg, device=self.device,
                                          generator=generator)
        self.backbone.requires_grad_(False)          # frozen
        self.feat_dim = self.vit_cfg.embed_dim
        self.head = ExpansionHead(self.feat_dim, cfg.hidden_dim, generator)
        pq_params, pq_state = pq_init(generator, cfg.pq)
        self.pq = nn.ParameterDict(pq_params)
        self.pq_state = _Buffers(pq_state)
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        """The probes' input width for ``eval.output_type``: ``feat`` (the
        head's code) and ``vqN`` are both ``hidden_dim``."""
        return self.cfg.hidden_dim

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """Frozen backbone dense features (b, gh, gw, C) in f32."""
        with torch.no_grad():
            return self.backbone(img)["dense"].float()

    def encode(self, feat: torch.Tensor) -> torch.Tensor:
        """Expansion head: (b, gh, gw, C) -> (b, gh, gw, hidden_dim)."""
        return self.head(feat)

    @property
    def needs_data_init(self) -> bool:
        return needs_data_init(self.cfg.pq)

    @torch.no_grad()
    def data_init(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                  **draws: Any) -> Dict[str, torch.Tensor]:
        """The first batch's ``kmeans`` / ``rand`` codebook init on the
        head's code of ``img`` (no dropout): the new tensors by name, for
        the caller to copy in (``Trainer.data_init``)."""
        code = self.encode(self.features(img))
        zf = code.reshape(-1, self.cfg.pq.num_pq, self.cfg.pq.sub_dim)
        return pq_data_init_named(zf, dict(self.pq), self.pq_state.as_dict(), self.cfg.pq,
                                  generator, draws, 0, "pq.", "pq_state.")[0]

    def forward(self, img: Optional[torch.Tensor] = None,
                img_pos: Optional[torch.Tensor] = None, *,
                feat: Optional[torch.Tensor] = None,
                feat_pos: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                stego_override: Optional[Tuple] = None) -> Dict[str, Any]:
        """The counterpart of ``EQUSS.apply``: images (or cached dense
        features) -> ``feat``, ``code``, ``z_q`` (b, gh, gw, hidden_dim),
        ``indices`` (b, gh, gw, M) int32 and ``aux``.

        Inference (``training=False``) runs without autograd; aux holds
        ``vq-loss`` and ``codebook-sum``.

        Training takes the kNN positives ``img_pos`` (or ``feat`` and
        ``feat_pos``): one backbone pass over ``[img; img_pos]`` without
        autograd (the frozen backbone), channel dropout drawn from
        ``generator``, the head on both halves, the quantizer on the first
        and the STEGO loss (``aux['stego-loss']``; ``stego_override`` =
        ``(coords1, coords2, perms)`` replaces its random draws); an EMA
        quantizer adds ``jsd`` and ``entropy`` between the first and the
        second half of the pixels' ``distance_prob``.  The quantizer's new
        state is returned under ``state`` by buffer name
        (``pq_state.<name>``) and is not applied: the caller decides."""
        if not training:
            with torch.no_grad():
                if feat is None:
                    if img is None:
                        raise ValueError("forward needs img or feat")
                    feat = self.features(img)
                code = self.encode(feat)
                z_q, indices, aux, _ = pq_forward(
                    code, dict(self.pq), self.pq_state.as_dict(), self.cfg.pq)
            return {"feat": feat, "code": code, "z_q": z_q, "indices": indices,
                    "aux": aux}

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
        code_both = self.encode(both)
        feat, feat_pos = both[:b], both[b:]
        code, code_pos = code_both[:b], code_both[b:]
        z_q, indices, aux, pq_state = pq_forward(
            code, dict(self.pq), self.pq_state.as_dict(), cfg.pq, training=True,
            generator=generator)
        aux["stego-loss"] = stego_loss(generator, feat, feat_pos, code, code_pos,
                                       cfg.stego, sample_override=stego_override)
        if cfg.pq.vq_type == "ema" and "distance_prob" in aux:
            # between the two halves of the global batch's pixels, which in
            # a global program may lie on other ranks: every rank computes
            # the global terms, and a weighted JSD's gradient goes back to
            # the rows' owners through the gather
            prob = mesh.gather_rows(aux["distance_prob"])
            flat = prob.reshape(-1, *prob.shape[-2:])
            half = flat.shape[0] // 2
            # a K-sharded quantizer's softmax is its shard's: the sums over K
            # run over the model group
            aux["jsd"], aux["entropy"] = ema_jsd_entropy(
                flat[:half], flat[half:2 * half], sharded=flat.shape[-1] != cfg.pq.num_codebook)
        return {"feat": feat, "code": code, "z_q": z_q, "indices": indices,
                "aux": aux, "state": {f"pq_state.{k}": v for k, v in pq_state.items()}}
