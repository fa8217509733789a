"""Weight bridge: JAX pytrees and DINO checkpoints -> the port's state dict.

* ``params_from_jax`` maps the ``(params, state)`` pytrees of the JAX
  package's ``EQUSS.init`` (numpy-valued) onto ``EQUSS.state_dict()``
  names, so both packages compute with the same numbers.
* ``load_dino_state_dict`` reads a local DINO ``.pth`` (the torch key
  names ``equss_tpu.models.vit.convert_dino_torch_state`` consumes) into
  the port's ``VisionTransformer`` names.

Layouts: a flax Dense ``kernel (in, out)`` is the port's ``weight (out,
in)``; the flax patch conv ``(kh, kw, in, out)`` and the torch patch conv
``(out, in, kh, kw)`` both become the port's patch matmul ``(out, kh*kw*in)``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from equss_tpu_torch.models.equss import EQUSSConfig
from equss_tpu_torch.models.vit import VIT_PRESETS


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(tree: Mapping[str, Any], name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _t(tree["kernel"]).T.contiguous(),
            f"{name}.bias": _t(tree["bias"])}


def _norm(tree: Mapping[str, Any], name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _t(tree["scale"]), f"{name}.bias": _t(tree["bias"])}


def backbone_from_flax(bb: Mapping[str, Any], depth: int) -> Dict[str, torch.Tensor]:
    """Flax ``VisionTransformer`` params -> port ``VisionTransformer`` state."""
    kernel = _t(bb["patch_embed"]["kernel"])                 # (kh, kw, in, out)
    sd = {
        "patch_embed.weight": kernel.reshape(-1, kernel.shape[-1]).T.contiguous(),
        "patch_embed.bias": _t(bb["patch_embed"]["bias"]),
        "cls_token": _t(bb["cls_token"]),
        "pos_embed": _t(bb["pos_embed"]),
        **_norm(bb["norm"], "norm"),
    }
    for i in range(depth):
        blk = bb[f"blocks_{i}"]
        p = f"blocks.{i}"
        sd.update(_norm(blk["norm1"], f"{p}.norm1"))
        sd.update(_norm(blk["norm2"], f"{p}.norm2"))
        sd.update(_dense(blk["attn"]["qkv"], f"{p}.attn.qkv"))
        sd.update(_dense(blk["attn"]["proj"], f"{p}.attn.proj"))
        sd.update(_dense(blk["mlp"]["fc1"], f"{p}.mlp.fc1"))
        sd.update(_dense(blk["mlp"]["fc2"], f"{p}.mlp.fc2"))
    return sd


def head_from_flax(head: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``ExpansionHead`` params -> port ``ExpansionHead`` state."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("cluster1", "cluster2_fc1", "cluster2_fc2"):
        sd.update(_dense(head[name], name))
    return sd


def params_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                    cfg: EQUSSConfig) -> Dict[str, torch.Tensor]:
    """JAX ``EQUSS.init`` pytrees -> port ``EQUSS`` state dict (CPU f32)."""
    depth = VIT_PRESETS[cfg.model_type][1]
    sd = {f"backbone.{k}": v
          for k, v in backbone_from_flax(params["backbone"], depth).items()}
    sd.update({f"head.{k}": v for k, v in head_from_flax(params["head"]).items()})
    sd.update({f"pq.{k}": _t(v) for k, v in params["pq"].items()})
    sd.update({f"pq_state.{k}": _t(v) for k, v in state["pq"].items()})
    return sd


def dino_to_port(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """DINO torch key names -> port ``VisionTransformer`` state.  Every
    name carries over except the patch conv, which becomes the patch
    matmul; the DINO head (if any) is dropped."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        v = v.detach().float().cpu()
        if k == "patch_embed.proj.weight":
            out["patch_embed.weight"] = v.permute(0, 2, 3, 1).reshape(v.shape[0], -1).contiguous()
        elif k == "patch_embed.proj.bias":
            out["patch_embed.bias"] = v
        elif k.startswith(("blocks.", "norm.", "cls_token", "pos_embed")):
            out[k] = v
    return out


def load_dino_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A local DINO ``.pth`` -> port ``VisionTransformer`` state.  A
    training checkpoint's ``teacher`` entry is taken, and ``module.`` /
    ``backbone.`` prefixes are stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "teacher" in sd:
        sd = sd["teacher"]
    sd = {k.replace("module.", "").replace("backbone.", ""): v
          for k, v in sd.items()}
    return dino_to_port(sd)
