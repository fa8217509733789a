"""Seeded random weights of an EQUSS model and its probes, made on the
device in two calls (one normal draw, one uniform draw) and cut into
tensors under the names the port's ``Trainer.load_state_dict`` takes.
The backbone's tensors are its module's (``reference/backbone_<name>.py``).

Every weight is f32, as the port stores its parameters.  Scales: each
matrix N(0, 1/fan_in); biases, the CLS token and the position embedding
N(0, 0.02^2); LayerNorm scales 1 + N(0, 0.1^2) and shifts N(0, 0.05^2),
so that no affine parameter sits at its identity value; the codebook
xavier-uniform (``need_initialized: uni``); the cluster centroids
N(0, 1).  The usage counts start at zero.  The same seed gives the same
tensors on the same card, so the reference draws them again after the
window instead of keeping a copy.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from perfbench import cell as cells
from perfbench.traffic import sub_seed

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def weight_spec(w: Dict[str, Any], classes: int) -> Spec:
    """(name, shape, draw, scale) of every tensor: draw ``normal`` (scale
    is the std, ``+1`` added where the name ends in ``norm*.weight``),
    ``uniform`` (scale is the bound) or ``zeros``.  The backbone's
    tensors come first, in its module's order (``cell.backbone``)."""
    d, hid = w["embed_dim"], w["hidden"]
    M, K = w["num_pq"], w["num_codebook"]
    spec: Spec = list(cells.backbone(w).weight_spec(w))
    spec += [
        ("head.cluster1.weight", (hid, d), "normal", d ** -0.5),
        ("head.cluster1.bias", (hid,), "normal", 0.02),
        ("head.cluster2_fc1.weight", (d, d), "normal", d ** -0.5),
        ("head.cluster2_fc1.bias", (d,), "normal", 0.02),
        ("head.cluster2_fc2.weight", (hid, d), "normal", d ** -0.5),
        ("head.cluster2_fc2.bias", (hid,), "normal", 0.02),
        ("pq.codebook", (M, K, hid // M), "uniform", math.sqrt(6.0 / (K + hid // M))),
        ("pq_state.vq_count", (M, K), "zeros", 0.0),
        ("probes.linear_probe.linear.weight", (classes, hid), "normal", hid ** -0.5),
        ("probes.linear_probe.linear.bias", (classes,), "normal", 0.02),
        ("probes.cluster_probe.clusters", (classes, hid), "normal", 1.0),
    ]
    return spec


def _is_norm_scale(name: str) -> bool:
    return name.split(".")[-2].startswith("norm") and name.endswith(".weight")


def make_weights(w: Dict[str, Any], classes: int, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The state dict of ``weight_spec`` drawn from ``seed`` on ``device``."""
    spec = weight_spec(w, classes)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in spec if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=g, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=g, device=device)}
    at = {"normal": 0, "uniform": 0}
    out: Dict[str, torch.Tensor] = {}
    for name, shape, kind, scale in spec:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        t = pools[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        if kind == "uniform":
            t = t.mul(2 * scale).sub_(scale)
        else:
            t = t.mul(scale)
            if _is_norm_scale(name):
                t.add_(1.0)
        out[name] = t
    return out
