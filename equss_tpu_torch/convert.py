"""Weight bridge: JAX pytrees and DINO checkpoints -> the port's state dict.

* ``params_from_jax`` maps the ``(params, state)`` pytrees of a JAX
  registry model's ``init`` (numpy-valued: EQUSS's backbone, head, PQ
  parameters and quantizer state, param or EMA; STEGO's backbone and
  head; the probe-only model's backbone; the variants' encoders,
  decoders, prototypes, classifier, SPQ's codebook, the VAE's convolutions,
  EMAModel's centroids and the lists of quantizers, and their state: the
  SwAV queue and counters, the EMA heads, the CLUB encoder with its Adam
  moments and count, BatchNorm's running averages, EMAModel's memory bank,
  each list entry's quantizer state) onto the port model's
  ``state_dict()`` names, and the Trainer's probe parameters onto
  ``Evaluator`` names under ``probes.``, so both packages compute with the
  same numbers.
* ``train_state_from_jax`` turns a whole JAX train state (weights, the
  three optax Adam states, wrapped in ``MultiSteps`` under gradient
  accumulation, the step) into ``Trainer.load_train_state``'s format, so
  a run can continue in the port where the JAX package left it.
* ``load_dino_state_dict`` reads a local DINO ``.pth`` (the torch key
  names ``equss_tpu.models.vit.convert_dino_torch_state`` consumes) into
  the port's ``VisionTransformer`` names.

Layouts: a flax Dense ``kernel (in, out)`` is the port's ``weight (out,
in)``, a flax norm's ``scale`` its ``weight``, and every other leaf keeps
its name (and an integer leaf its dtype); a list's i-th entry takes the
name ``i``; the flax patch conv ``(kh, kw, in, out)`` and the torch patch
conv ``(out, in, kh, kw)`` both become the port's patch matmul ``(out,
kh*kw*in)``, any other flax conv kernel torch's ``(out, in, kh, kw)``,
except the VAE's ``ConvTranspose2dTorch`` kernels (``TRANSPOSED_CONVS``):
JAX keeps them as (kh, kw, out, in) applied as a correlation over the
dilated input, which is torch's transposed convolution of the kernel
flipped in both spatial axes, so they become ``(in, out, kh, kw)``
flipped.
"""
from __future__ import annotations

import types
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from equss_tpu_torch.models.vit import VIT_PRESETS


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _leaf(x: Any) -> torch.Tensor:
    """An f32 tensor, or an int32 one for an integer leaf (a counter)."""
    a = np.asarray(x)
    return torch.from_numpy(np.array(a, dtype=np.int32 if a.dtype.kind in "iu" else np.float32))


# the flax modules whose 4-D kernel is a ConvTranspose2dTorch's
TRANSPOSED_CONVS = ("dec_top_up", "upsample_t")


def tree_from_flax(tree: Any, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax subtree -> port names under ``prefix``: ``kernel`` becomes a
    transposed ``weight`` (a conv's (kh, kw, in, out) torch's (out, in,
    kh, kw); a ``TRANSPOSED_CONVS`` kernel torch's transposed-convolution
    weight), ``scale`` a ``weight``, the i-th entry of a list (the
    quantizers) ``<prefix>i.``, other leaves keep their names."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    sd: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, (Mapping, list, tuple)):
            sd.update(tree_from_flax(v, f"{prefix}{k}."))
        elif k == "kernel" and np.ndim(v) == 4:
            w = _t(v).permute(3, 2, 0, 1)
            if prefix.rstrip(".").rsplit(".", 1)[-1] in TRANSPOSED_CONVS:
                w = w.flip(2, 3)
            sd[f"{prefix}weight"] = w.contiguous()
        elif k == "kernel":
            sd[f"{prefix}weight"] = _t(v).T.contiguous()
        elif k == "scale":
            sd[f"{prefix}weight"] = _t(v)
        else:
            sd[f"{prefix}{k}"] = _leaf(v)
    return sd


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
    return tree_from_flax(head, "")


def probes_from_flax(probes: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``Evaluator`` params -> port ``Evaluator`` state: the linear
    probe's Dense and the cluster probe's centroids."""
    sd = _dense(probes["linear_probe"]["linear"], "linear_probe.linear")
    if "cluster_probe" in probes:
        sd["cluster_probe.clusters"] = _t(probes["cluster_probe"]["clusters"])
    return sd


def _trainable_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Every subtree but the backbone (the trainable parameters: a head,
    the quantizer's ``pq``, the variants' encoders, decoder, prototypes
    and classifier) -> port names."""
    return tree_from_flax({k: v for k, v in tree.items() if k != "backbone"}, "")


def _adam_moments(opt_state: Any, prefix: str) -> Dict[str, torch.Tensor]:
    """An optax Adam state kept as model state (the CLUB encoder's) ->
    ``<prefix>mu.*``, ``<prefix>nu.*`` and the int32 ``<prefix>count``."""
    adam, _ = _adam_state(opt_state)
    return {**tree_from_flax(adam.mu, f"{prefix}mu."), **tree_from_flax(adam.nu, f"{prefix}nu."),
            f"{prefix}count": _leaf(adam.count)}


def state_from_flax(state: Mapping[str, Any],
                    batch_stats_prefix: str = "dec.") -> Dict[str, torch.Tensor]:
    """A JAX model's ``state`` -> port buffer names: the quantizer's under
    ``pq_state.`` (a list of quantizers under ``pq_state.<i>.``), the EMA
    head and the CLUB encoder by their names, the CLUB optimizer's Adam
    state under ``club_opt.``, the BatchNorm statistics under
    ``batch_stats_prefix`` (``dec.``: ``res``'s decoder; ``net.``: the
    BatchNorms inside a ``net`` torso), and top-level arrays (the SwAV
    queue and counters, EMAModel's queue and flag) as they are."""
    sd: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if k == "pq":
            sd.update({n: t.float() for n, t in tree_from_flax(v, "pq_state.").items()})
        elif k == "club_opt":
            sd.update(_adam_moments(v, "club_opt."))
        elif k == "batch_stats":
            sd.update(tree_from_flax(v, batch_stats_prefix))
        elif isinstance(v, Mapping):
            sd.update(tree_from_flax(v, f"{k}."))
        else:
            sd[k] = _leaf(v)
    return sd


def batch_stats_prefix(params: Mapping[str, Any]) -> str:
    """Where a JAX model's ``batch_stats`` live in the port: inside
    ``net.`` for a model whose trainable torso is one flax module ``net``
    (UnSeg, Contra, NewVQ, Info), else under ``dec.`` (``res``'s
    decoder)."""
    return "net." if "net" in params else "dec."


def params_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                    cfg: Any, probe_params: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX model pytrees (``init``'s ``params`` and ``state``) -> the port
    model's state dict (CPU f32); ``cfg`` is the model's config (its
    ``model_type`` gives the backbone's depth).  With ``probe_params`` (a
    JAX Trainer state's ``probe_params``) the probes come along under
    ``probes.``, the names ``Trainer.load_state_dict`` routes to its
    ``Evaluator``."""
    depth = VIT_PRESETS[cfg.model_type][1]
    sd = {f"backbone.{k}": v
          for k, v in backbone_from_flax(params["backbone"], depth).items()}
    sd.update(_trainable_from_flax(params))
    sd.update(state_from_flax(state, batch_stats_prefix(params)))
    if probe_params is not None:
        sd.update({f"probes.{k}": v for k, v in probes_from_flax(probe_params).items()})
    return sd


def _adam_state(opt_state: Any) -> Tuple[Any, int]:
    """The ``ScaleByAdamState`` (``mu``, ``nu``, ``count``) of an optax
    chain's state and the ``ScaleByScheduleState`` count beside it."""
    adam, sched = None, None
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if hasattr(node, "mu") and hasattr(node, "nu"):
            adam = adam or node
        elif type(node).__name__ == "ScaleByScheduleState":
            sched = sched if sched is not None else node
        elif isinstance(node, (tuple, list)):
            stack.extend(reversed(node))
    if adam is None:
        raise NotImplementedError("only adam and adamw optimizer states convert")
    count = int(np.asarray(sched.count if sched is not None else adam.count))
    return adam, count


def _opt_from_jax(opt_state: Any, flat: Callable[[Any], Dict[str, torch.Tensor]]
                  ) -> Dict[str, Any]:
    """One optax Adam state -> ``Optimizer.state_dict()``: ``flat`` maps
    a moment tree onto the port's parameter names (and layouts).  A
    ``MultiSteps`` state adds its ``mini_step`` and gradient mean
    (``acc``)."""
    adam, count = _adam_state(opt_state)
    step = torch.tensor(float(np.asarray(adam.count)))
    mu, nu = flat(adam.mu), flat(adam.nu)
    out = {"count": count,
           "state": {n: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                     for n in mu}}
    if hasattr(opt_state, "mini_step"):
        out.update(mini_step=int(np.asarray(opt_state.mini_step)),
                   acc=flat(opt_state.acc_grads))
    return out


def train_state_from_jax(host_ts: Mapping[str, Any], cfg: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``Trainer`` state as ``jax.device_get(ts)`` gives it -> the
    port's ``Trainer.train_state()`` format: the weights (``params``,
    ``model_state``, ``probe_params``), each optimizer's moments by the
    port's parameter names (a flax kernel's moments transposed with it)
    with Adam's count and the schedule position, and ``step``.  JAX's
    PRNG key has no torch counterpart, so the state carries no generator
    and ``load_train_state`` keeps the trainer's own.  Any registry model
    converts: an optimizer over nothing (the probe-only model's, or the
    cluster probe's in supervised mode) keeps only its counts."""
    mcfg = types.SimpleNamespace(model_type=cfg["model"]["pretrained"]["model_type"])
    opt = host_ts["opt"]
    return {
        "model": params_from_jax(host_ts["params"], host_ts["model_state"], mcfg),
        "probes": probes_from_flax(host_ts["probe_params"]),
        "opt": {"model": _opt_from_jax(opt["model"], _trainable_from_flax),
                "cluster": _opt_from_jax(opt["cluster"],
                                         lambda t: {"clusters": _t(t["clusters"])}
                                         if "clusters" in t else {}),
                "linear": _opt_from_jax(opt["linear"],
                                        lambda t: _dense(t["linear"], "linear"))},
        "step": int(np.asarray(host_ts["step"])),
        "generator": None,
        "generator_device": None,
    }


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
