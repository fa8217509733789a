"""The port's model registry and quantizer routing against the JAX package.

* ``resolve_model_name`` names the model the JAX registry names for every
  file in ``configs/``, by ``model.name`` and by the run-name fallback
  alone; ``build_model`` builds ``EQUSS`` for ``pqgo`` and ``vq``,
  ``STEGOModel`` for ``stego`` and ``sl``, ``ProbeOnlyModel`` for
  ``probe`` and the variants ``pqgocls``, ``cluster`` (margin and SwAV),
  ``res``, ``hihi`` (UnSeg), ``new`` (NewVQ), ``spq``, ``vae``, ``info``,
  ``contra`` and ``ema``: every family of ``equss_tpu/models/variants.py``
  (``VARIANTS``, the families still to port, is empty).
* ``pq_config_from_dict`` gives JAX's ``PQConfig`` field for field for
  every config with a quantizer (``decay``, ``eps`` and ``jsd_ts``
  included); ``STEGOConfig`` and ``ProbeOnlyConfig`` read what JAX's read.
* ``_kernel_shape_ok`` on a CUDA device (pure Python, so it runs here) for
  every quantizer of every config: True wherever the JAX predicate takes
  its kernel (d % 8 == 0, K % 128 == 0), and a ``ValueError`` with the
  reason, never a quiet False, should the kernel's domain leave such a
  shape out; outside the predicate the kernel's domain decides.
* ``model.pretrained.ln_stats: bf16`` reaches the backbone of every
  model that reads it in JAX (EQUSS, STEGO, the probe-only model and
  the variants): its norms take bf16 statistics.
"""
import dataclasses
import glob
import os

import pytest
import torch

import jax.numpy as jnp

from equss_tpu.core.config import load_config
from equss_tpu.models import equss as jequss
from equss_tpu.models import registry as jregistry
from equss_tpu.models.probe_only import ProbeOnlyConfig as JProbeOnlyConfig
from equss_tpu.models.stego import STEGOConfig as JSTEGOConfig
from equss_tpu_torch.models import equss as tequss
from equss_tpu_torch.models import registry
from equss_tpu_torch.models.probe_only import ProbeOnlyConfig, ProbeOnlyModel
from equss_tpu_torch.models.stego import STEGOConfig, STEGOModel
from equss_tpu_torch.ops.pq_assign import kernel_domain_error
from equss_tpu_torch.ops import quantizer as tq

CONFIGS = sorted(glob.glob("configs/*.yaml"))
IDS = [os.path.basename(p)[:-5] for p in CONFIGS]
VQ_CONFIGS = [p for p in CONFIGS if "vq" in load_config(p)["model"]]


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_resolve_model_name_matches_jax(path):
    cfg = load_config(path)
    assert registry.resolve_model_name(cfg) == jregistry.resolve_model_name(cfg)
    by_run_name = dict(cfg, model={k: v for k, v in cfg["model"].items() if k != "name"})
    try:
        want = jregistry.resolve_model_name(by_run_name)
    except ValueError:
        with pytest.raises(ValueError, match="run name"):
            registry.resolve_model_name(by_run_name)
    else:
        assert registry.resolve_model_name(by_run_name) == want


def test_registry_names_and_errors_match_jax():
    assert registry.available_models() == jregistry.available_models()
    assert registry._KEYWORD_ORDER == jregistry._KEYWORD_ORDER
    with pytest.raises(ValueError, match="Unknown model"):
        registry.resolve_model_name({"model": {"name": "nope"}})


@pytest.mark.parametrize("path", VQ_CONFIGS, ids=[os.path.basename(p)[:-5] for p in VQ_CONFIGS])
def test_pq_config_from_dict_matches_jax(path):
    vq = load_config(path)["model"]["vq"]
    assert dataclasses.asdict(tequss.pq_config_from_dict(vq)) == \
        dataclasses.asdict(jequss.pq_config_from_dict(vq))


def test_vq_config_reads_the_ema_settings():
    pq = tequss.pq_config_from_dict(load_config("configs/vq_cocostuff27.yaml")["model"]["vq"])
    assert (pq.vq_type, pq.num_pq, pq.num_codebook, pq.sub_dim) == ("ema", 1, 256, 1024)
    assert (pq.decay, pq.eps, pq.jsd_ts) == (0.99, 1.0e-6, 1.0)
    assert tq.PQConfig().eps == 1.0e-5 and tq.PQConfig().decay == 0.99


MODEL_CONFIGS = ["stego_cocostuff27", "stego_pascal", "stego_potsdam", "sl_cocostuff27",
                 "cluster_baseline"]


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_model_configs_match_jax(name):
    cfg = load_config(f"configs/{name}.yaml")
    if name == "cluster_baseline":
        mine, want = ProbeOnlyConfig.from_config(cfg), JProbeOnlyConfig.from_config(cfg)
        shared = ("model_type", "patch_size", "attn_bf16", "gelu", "ln_stats")
    else:
        mine, want = STEGOConfig.from_config(cfg), JSTEGOConfig.from_config(cfg)
        shared = ("model_type", "patch_size", "dim", "dropout", "drop_prob", "attn_bf16", "gelu",
                  "ln_stats")
        assert dataclasses.asdict(mine.stego) == dataclasses.asdict(want.stego)
    for field in shared:
        assert getattr(mine, field) == getattr(want, field), field
    assert (mine.backbone_dtype == torch.bfloat16) == (want.backbone_dtype == jnp.bfloat16)


def _micro(name):
    cfg = load_config(f"configs/{name}.yaml")
    cfg["model"]["pretrained"]["model_type"] = "vit_micro"
    return cfg


@pytest.mark.parametrize("name,kind", [
    ("pqgo_cocostuff27", tequss.EQUSS), ("vq_cocostuff27", tequss.EQUSS),
    ("stego_cocostuff27", STEGOModel), ("sl_cocostuff27", STEGOModel),
    ("cluster_baseline", ProbeOnlyModel)])
def test_build_model_builds_each_ported_family(name, kind):
    cfg = _micro(name)
    model = registry.build_model(cfg, device="cpu", seed=3)
    assert type(model) is kind and model.device == torch.device("cpu")
    out_dim = {"stego_cocostuff27": 70, "sl_cocostuff27": 70, "cluster_baseline": 32}
    assert model.output_dim(cfg["eval"]["output_type"]) == out_dim.get(name, 1024)
    again = registry.build_model(cfg, device="cpu", seed=3)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    if kind is ProbeOnlyModel:
        assert all(not p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("name,config", [
    ("pqgocls", "pqgo_cls_cocostuff27"), ("cluster", "cluster_margin_cocostuff27"),
    ("cluster", "cluster_swav_cocostuff27"), ("res", "res_cocostuff27"),
    ("hihi", "unseg_cocostuff27"), ("new", "new_vq_cocostuff27"), ("spq", "spq_cocostuff27"),
    ("vae", "vae_cocostuff27"), ("info", "info_cocostuff27"), ("contra", "contra_cocostuff27"),
    ("ema", "ema_cocostuff27")])
def test_variant_families_of_this_slice_build(name, config):
    """Each builds on the CPU, resolves by ``model.name`` and by a run name
    holding its keyword, and reports the probes' width the JAX model does
    (VAE's ``feat``, the decoder's input, where JAX's says ``feat_dim``).
    No family is left to port."""
    from equss_tpu_torch.models import variants

    cfg = _micro(config)
    assert registry.resolve_model_name(cfg) == name
    by_run_name = dict(cfg, model={k: v for k, v in cfg["model"].items() if k != "name"})
    # pqgo_cls_* reads as pqgo in both; unseg_* names no keyword in either
    assert _resolved(registry, by_run_name) == _resolved(jregistry, by_run_name)
    by_run_name["wandb"] = {"name": f"{name}_run"}
    assert registry.resolve_model_name(by_run_name) == name
    model = registry.build_model(cfg, device="cpu", seed=3)
    kind = {"pqgocls": variants.PQGOCLSModel, "cluster": variants.ClusterModel,
            "res": variants.ResModel, "hihi": variants.UnSegModel,
            "new": variants.NewVQModel, "spq": variants.SPQModel, "vae": variants.VAEModel,
            "info": variants.InfoModel, "contra": variants.ContraModel,
            "ema": variants.EMAModel}[name]
    assert type(model) is kind and model.device == torch.device("cpu")
    want = jregistry.build_model(cfg).output_dim(cfg["eval"]["output_type"])
    assert model.output_dim(cfg["eval"]["output_type"]) == want
    assert not any(n.startswith(("ema_head.", "club_enc.", "club_opt."))
                   for n, _ in model.named_parameters())
    assert registry.VARIANTS == {}


@pytest.mark.parametrize("name", ["pqgo_cocostuff27", "stego_cocostuff27", "cluster_baseline",
                                  "contra_cocostuff27"])
def test_ln_stats_reaches_every_model(name):
    from equss_tpu_torch.models.vit import BF16StatsLayerNorm, LayerNorm

    cfg = _micro(name)
    cfg["model"]["pretrained"].update(precision="bf16", ln_stats="bf16")
    model = registry.build_model(cfg, device="cpu", seed=3)
    assert type(model.backbone.norm) is BF16StatsLayerNorm
    assert type(model.backbone.blocks[0].norm1) is BF16StatsLayerNorm
    assert model.vit_cfg.ln_stats_bf16
    assert tequss.backbone_settings(cfg["model"]["pretrained"])["ln_stats"] == "bf16"
    cfg["model"]["pretrained"]["ln_stats"] = "f32"
    assert type(registry.build_model(cfg, device="cpu", seed=3).backbone.norm) is LayerNorm


def _resolved(reg, cfg):
    """``reg.resolve_model_name(cfg)``, or the ValueError's first words."""
    try:
        return reg.resolve_model_name(cfg)
    except ValueError as e:
        return str(e).split(";")[0]


def _quantizers(cfg):
    """(M, K, d, precision) of every quantizer a config lists."""
    vq = cfg["model"]["vq"]
    num_pq = vq.get("num_pq") or 1
    out = []
    for i, (K, D) in enumerate(zip(vq["num_codebooks"], vq["embed_dims"])):
        M = num_pq[i] if isinstance(num_pq, list) else num_pq
        out.append((M, K, D // M, vq.get("assign_precision", "exact")))
    return out


@pytest.mark.parametrize("path", VQ_CONFIGS, ids=[os.path.basename(p)[:-5] for p in VQ_CONFIGS])
def test_kernel_shape_rule_on_cuda_never_takes_the_plain_route_quietly(path, monkeypatch):
    cuda = torch.device("cuda")
    for M, K, d, precision in _quantizers(load_config(path)):
        cfg = tq.PQConfig(num_pq=M, num_codebook=K, embed_dim=M * d, assign_precision=precision)
        jax_rule = d % 8 == 0 and K % 128 == 0
        inside = kernel_domain_error(d, K, precision != "bf16") is None
        assert tq._kernel_shape_ok(cfg, cuda) == (True if jax_rule else inside)
        assert tq._kernel_eligible(cfg, 10, cuda) == (True if jax_rule else inside)
        assert tq._kernel_shape_ok(cfg, torch.device("cpu")) == jax_rule
        with monkeypatch.context() as m:
            m.setattr(tq, "kernel_domain_error", lambda *a: "a shape the kernel lacks")
            if jax_rule:
                with pytest.raises(ValueError, match="a shape the kernel lacks"):
                    tq._kernel_eligible(cfg, 10, cuda)
            else:
                assert not tq._kernel_eligible(cfg, 10, cuda)
