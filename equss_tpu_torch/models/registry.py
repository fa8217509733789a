"""Model registry: ``model.name`` (or the run name) -> a model builder.

Counterpart of ``equss_tpu/models/registry.py``: ``register``,
``available_models``, ``resolve_model_name`` with the substring fallback
over ``wandb.name`` in ``_KEYWORD_ORDER``, and ``build_model``, which
takes the port's ``device`` and ``seed`` beside the config.  ``pqgo`` and
``vq`` build ``EQUSS``, ``stego`` and ``sl`` build ``STEGOModel``,
``probe`` builds ``ProbeOnlyModel``, and ``pqgocls``, ``cluster``,
``res``, ``hihi`` (UnSeg), ``new`` (NewVQ), ``spq``, ``vae``, ``info``,
``contra`` and ``ema`` build the ``models/variants.py`` families of those
names.  ``VARIANTS`` lists the families of the JAX package still to port
(registered name -> (JAX class, ROADMAP.md queue 1 item)); it is empty:
every family of ``equss_tpu/models/variants.py`` is ported.

Every family runs data-parallel, as one global program over the ranks
of a process group (``parallel/mesh.py``): what couples a batch's rows
(the view's and the quantizers' draws, InfoNCE, the margin, the JSDs,
CLUB and its encoder's inner steps, BatchNorm, the Sinkhorn and the SwAV
queue, the EMA bank, the k-means stages) reduces or gathers over the
ranks, as ``models/variants.py`` says.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from equss_tpu_torch.device import DeviceLike

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}

# the substring fallback's order (the reference's dispatch order)
_KEYWORD_ORDER = [
    "hihi", "sl", "pqgocls", "pqgo", "stego", "spq", "new", "cluster",
    "res", "contra", "vae", "info", "ema", "vq",
]

# the models/variants.py families still to port: registered name ->
# (JAX class, ROADMAP.md queue 1 item that ports it)
VARIANTS: Dict[str, Any] = {}


def register(name: str):
    def deco(builder):
        _REGISTRY[name] = builder
        return builder
    return deco


def available_models():
    return sorted(_REGISTRY)


def resolve_model_name(cfg: Dict[str, Any]) -> str:
    """``model.name`` when set (it must be registered), else the first
    keyword of ``_KEYWORD_ORDER`` found in the lower-cased ``wandb.name``."""
    name = cfg.get("model", {}).get("name")
    if name:
        if name not in _REGISTRY:
            raise ValueError(f"Unknown model '{name}'; available: {available_models()}")
        return name
    run_name = (cfg.get("wandb", {}) or {}).get("name", "").lower()
    for kw in _KEYWORD_ORDER:
        if kw in run_name and kw in _REGISTRY:
            return kw
    raise ValueError(
        f"Could not resolve model from run name '{run_name}'; set model.name "
        f"to one of {available_models()}")


def build_model(cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0) -> nn.Module:
    """Config dict -> the model, its weights drawn from ``seed`` on the
    CPU and moved to ``device`` (None means CUDA)."""
    return _REGISTRY[resolve_model_name(cfg)](cfg, device=device, seed=seed)


# ---------------------------------------------------------------- builders

@register("pqgo")
def _build_pqgo(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig

    return EQUSS(EQUSSConfig.from_config(cfg), device=device, seed=seed)


@register("vq")
def _build_vq(cfg, *, device=None, seed=0):
    # the VQ/PQ baselines are EQUSS with other quantizer settings
    return _build_pqgo(cfg, device=device, seed=seed)


@register("stego")
def _build_stego(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.stego import STEGOConfig, STEGOModel

    return STEGOModel(STEGOConfig.from_config(cfg), device=device, seed=seed)


@register("probe")
def _build_probe(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.probe_only import ProbeOnlyConfig, ProbeOnlyModel

    return ProbeOnlyModel(ProbeOnlyConfig.from_config(cfg), device=device, seed=seed)


@register("sl")
def _build_sl(cfg, *, device=None, seed=0):
    # supervised linear training on the STEGO head: the trainer's
    # supervised mode routes the probe's cross-entropy into the head
    return _build_stego(cfg, device=device, seed=seed)


@register("pqgocls")
def _build_pqgocls(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import PQGOCLSModel

    return PQGOCLSModel(cfg, device=device, seed=seed)


@register("cluster")
def _build_cluster(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import ClusterModel

    return ClusterModel(cfg, device=device, seed=seed)


@register("res")
def _build_res(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import ResModel

    return ResModel(cfg, device=device, seed=seed)


@register("hihi")
def _build_unseg(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import UnSegModel

    return UnSegModel(cfg, device=device, seed=seed)


@register("new")
def _build_new_vq(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import NewVQModel

    return NewVQModel(cfg, device=device, seed=seed)


@register("spq")
def _build_spq(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import SPQModel

    return SPQModel(cfg, device=device, seed=seed)


@register("vae")
def _build_vae(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import VAEModel

    return VAEModel(cfg, device=device, seed=seed)


@register("info")
def _build_info(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import InfoModel

    return InfoModel(cfg, device=device, seed=seed)


@register("contra")
def _build_contra(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import ContraModel

    return ContraModel(cfg, device=device, seed=seed)


@register("ema")
def _build_ema(cfg, *, device=None, seed=0):
    from equss_tpu_torch.models.variants import EMAModel

    return EMAModel(cfg, device=device, seed=seed)

