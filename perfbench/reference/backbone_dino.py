"""DINO's ViT (arXiv:2104.14294), the backbone of a configuration whose
``widths`` name no ``backbone`` (or ``"dino"``): a CLS token, a learnt
position embedding at the drawn grid, pre-norm blocks of attention and a
GELU MLP, a last LayerNorm.

A backbone module gives the harness four things, by the names below:
``weight_spec`` (its ``backbone.*`` tensors in draw order, as
``perfbench/weights.py`` draws them), ``dense`` (the plain reference's
forward), ``tokens`` (the tokens one image puts through attention) and
``flops`` (one image's forward, as ``perfbench/yardstick.py`` counts).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.model import LN_EPS, Weights, linear
from perfbench.reference.precision import rnd


def weight_spec(w: Dict[str, int]) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, draw, scale) of every ``backbone.*`` tensor, in the
    order they are drawn."""
    d, p = w["embed_dim"], w["patch"]
    mlp = w["mlp_ratio"] * d
    grid = w["res"] // p
    spec = [
        ("backbone.cls_token", (1, 1, d), "normal", 0.02),
        ("backbone.pos_embed", (1, grid * grid + 1, d), "normal", 0.02),
        ("backbone.patch_embed.weight", (d, p * p * 3), "normal", (p * p * 3) ** -0.5),
        ("backbone.patch_embed.bias", (d,), "normal", 0.02),
    ]
    for i in range(w["depth"]):
        b = f"backbone.blocks.{i}."
        spec += [
            (b + "norm1.weight", (d,), "normal", 0.1),
            (b + "norm1.bias", (d,), "normal", 0.05),
            (b + "attn.qkv.weight", (3 * d, d), "normal", d ** -0.5),
            (b + "attn.qkv.bias", (3 * d,), "normal", 0.02),
            (b + "attn.proj.weight", (d, d), "normal", d ** -0.5),
            (b + "attn.proj.bias", (d,), "normal", 0.02),
            (b + "norm2.weight", (d,), "normal", 0.1),
            (b + "norm2.bias", (d,), "normal", 0.05),
            (b + "mlp.fc1.weight", (mlp, d), "normal", d ** -0.5),
            (b + "mlp.fc1.bias", (mlp,), "normal", 0.02),
            (b + "mlp.fc2.weight", (d, mlp), "normal", mlp ** -0.5),
            (b + "mlp.fc2.bias", (d,), "normal", 0.02),
        ]
    spec += [
        ("backbone.norm.weight", (d,), "normal", 0.1),
        ("backbone.norm.bias", (d,), "normal", 0.05),
    ]
    return spec


def dense(W: Weights, x: torch.Tensor, w: Dict[str, int], prec: str) -> torch.Tensor:
    """Normalised images (b, H, W, 3) -> the last block's normed patch
    tokens (b, H/p, W/p, d), f32."""
    b, H, Wd, _ = x.shape
    p, d, heads = w["patch"], w["embed_dim"], w["num_heads"]
    gh, gw = H // p, Wd // p
    if W["backbone.pos_embed"].shape[1] != gh * gw + 1:
        raise ValueError("the reference runs at the position embedding's own grid")
    patches = x.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, -1)
    t = linear(patches, W, "backbone.patch_embed", prec)
    t = torch.cat([W["backbone.cls_token"].expand(b, 1, d), t], 1) + W["backbone.pos_embed"]
    n, hd = t.shape[1], d // heads
    for i in range(w["depth"]):
        k = f"backbone.blocks.{i}."
        h = F.layer_norm(t, (d,), W[k + "norm1.weight"], W[k + "norm1.bias"], LN_EPS)
        qkv = linear(h, W, k + "attn.qkv", prec).reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, kk, v = qkv[0], qkv[1], qkv[2]
        att = torch.softmax(torch.matmul(rnd(q, prec), rnd(kk, prec).transpose(-1, -2))
                            * hd ** -0.5, dim=-1)
        o = torch.matmul(rnd(att, prec), rnd(v, prec)).transpose(1, 2).reshape(b, n, d)
        t = t + linear(o, W, k + "attn.proj", prec)
        h = F.layer_norm(t, (d,), W[k + "norm2.weight"], W[k + "norm2.bias"], LN_EPS)
        t = t + linear(F.gelu(linear(h, W, k + "mlp.fc1", prec)), W, k + "mlp.fc2", prec)
    t = F.layer_norm(t, (d,), W["backbone.norm.weight"], W["backbone.norm.bias"], LN_EPS)
    return t[:, 1:].reshape(b, gh, gw, d)


def tokens(w: Dict[str, int]) -> int:
    """The patch grid and the CLS token."""
    return (w["res"] // w["patch"]) ** 2 + 1


def vit_flops(res: int, patch: int, d: int, depth: int, mlp_ratio: int = 4) -> float:
    """One image through the ViT encoder (patch embedding and the
    blocks; the CLS token included)."""
    g = res // patch
    n = g * g + 1
    patch_embed = 2 * g * g * (patch * patch * 3) * d
    qkv = 2 * n * d * (3 * d)
    scores = 2 * n * n * d
    attnv = 2 * n * n * d
    proj = 2 * n * d * d
    mlp = 2 * 2 * n * d * (mlp_ratio * d)
    return patch_embed + depth * (qkv + scores + attnv + proj + mlp)


def flops(w: Dict[str, int]) -> float:
    return vit_flops(w["res"], w["patch"], w["embed_dim"], w["depth"], w["mlp_ratio"])
