"""The port's inference slice as a whole vs the JAX package.

``equss_tpu.models.equss.EQUSS.apply(training=False)`` and the port's
``EQUSS.forward`` on the same weights (JAX init -> ``params_from_jax``)
and the same images from a numpy seed, at vit_micro size with
PQ 4 x 128 (d = 16).

* f32 backbone, exact PQ: z_q within 1e-5, indices equal on >= 99.9% of
  pixels (features agree to ~1e-5, which can only move an assignment
  whose two best distances are closer than that).
* bf16 backbone with attn_bf16, fast PQ through the kernel route on both
  sides: >= 99% index agreement (bf16 features differ by rounding order
  between XLA and torch).  The backbone's attention kernel path is held
  against JAX in tests/test_torch_vit.py.

Also: the DINO checkpoint bridge, the package's freedom from JAX, and
the entry points' CUDA default.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from equss_tpu.models import equss as jeq
from equss_tpu.models.vit import convert_dino_torch_state
from equss_tpu.ops.quantizer import PQConfig as JPQConfig
from equss_tpu_torch import EQUSS, EQUSSConfig, PQConfig, resolve_device
from equss_tpu_torch.convert import (
    backbone_from_flax,
    head_from_flax,
    load_dino_state_dict,
    params_from_jax,
)
from equss_tpu_torch.data.transforms import normalize_images
from equss_tpu_torch.models.vit import VisionTransformer, make_vit_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _models(dtype_j, dtype_t, precision, use_pallas, seed=0):
    pq = dict(num_pq=4, num_codebook=128, embed_dim=64, vq_type="param",
              normalize="l2", assign_precision=precision, use_pallas=use_pallas)
    common = dict(model_type="vit_micro", patch_size=8, hidden_dim=64,
                  attn_bf16=dtype_t == torch.bfloat16)
    cfg_j = jeq.EQUSSConfig(backbone_dtype=dtype_j, pq=JPQConfig(**pq),
                            dropout=False, **common)
    cfg_t = EQUSSConfig(backbone_dtype=dtype_t, pq=PQConfig(**pq), **common)
    model_j = jeq.EQUSS(cfg_j)
    params, state = model_j.init(jax.random.PRNGKey(seed), img_hw=(96, 96))
    model_t = EQUSS(cfg_t, device="cpu")
    model_t.load_state_dict(params_from_jax(params, state, cfg_t))
    return model_j, params, state, model_t


def _images(seed):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    from equss_tpu.data.transforms import normalize_images as jnorm
    img_j = jnorm(jnp.asarray(raw))
    img_t = normalize_images(torch.from_numpy(raw))
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=0, atol=1e-6)
    return img_j, img_t


def test_equss_f32_exact_matches_jax():
    model_j, params, state, model_t = _models(jnp.float32, torch.float32, "exact", "auto")
    img_j, img_t = _images(0)
    out_j, _ = model_j.apply(params, state, img_j, training=False)
    out_t = model_t(img_t)
    assert out_t["indices"].shape == (2, 12, 12, 4)
    assert out_t["indices"].dtype == torch.int32
    np.testing.assert_allclose(out_t["feat"].numpy(), np.asarray(out_j["feat"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out_t["z_q"].numpy(), np.asarray(out_j["z_q"]),
                               rtol=0, atol=1e-5)
    agree = np.mean(out_t["indices"].numpy() == np.asarray(out_j["indices"]))
    assert agree >= 0.999, agree
    np.testing.assert_allclose(float(out_t["aux"]["vq-loss"]),
                               float(out_j["aux"]["vq-loss"]), rtol=1e-4)


def test_equss_bf16_fast_kernel_route_matches_jax():
    model_j, params, state, model_t = _models(jnp.bfloat16, torch.bfloat16, "bf16", True)
    img_j, img_t = _images(1)
    out_j, _ = model_j.apply(params, state, img_j, training=False)
    out_t = model_t(img_t)
    assert np.isfinite(out_t["z_q"].numpy()).all()
    agree = np.mean(out_t["indices"].numpy() == np.asarray(out_j["indices"]))
    assert agree >= 0.99, agree


def test_expansion_head_and_dropout2d():
    """ExpansionHead in f32 against the flax head on the same weights
    (within 1e-5: f32 sums in another order); dropout2d zeroes whole
    channels per sample and scales the rest by 1/(1-p) — its random bits
    differ from JAX's by design, so its definition is what is held."""
    from equss_tpu.models.heads import ExpansionHead as JHead
    from equss_tpu_torch.models.heads import ExpansionHead, dropout2d

    x = np.random.RandomState(6).randn(2, 5, 4, 24).astype(np.float32)
    params = JHead(40).init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(JHead(40).apply({"params": params}, jnp.asarray(x)))
    head = ExpansionHead(24, 40, torch.Generator().manual_seed(0))
    head.load_state_dict(head_from_flax(params))
    with torch.no_grad():
        out = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    xt = torch.from_numpy(x) + 10.0                   # no zeros of its own
    y = dropout2d(torch.Generator().manual_seed(1), xt, 0.5)
    dropped = (y == 0).all(dim=(1, 2))                # (b, c) whole channels
    assert 0 < dropped.sum() < dropped.numel()
    kept = ~dropped[:, None, None, :].expand_as(y)
    torch.testing.assert_close(y[kept], xt[kept] / 0.5)
    assert dropout2d(torch.Generator(), xt, 0.0) is xt


def _dino_state(cfg, seed=0):
    """A DINO-named torch state dict, as the official checkpoints hold."""
    g = torch.Generator().manual_seed(seed)
    C, p = cfg.embed_dim, cfg.patch_size
    r = lambda *s: torch.randn(*s, generator=g) * 0.05   # noqa: E731
    sd = {"cls_token": r(1, 1, C), "pos_embed": r(1, cfg.pos_grid ** 2 + 1, C),
          "patch_embed.proj.weight": r(C, 3, p, p), "patch_embed.proj.bias": r(C),
          "norm.weight": 1 + r(C), "norm.bias": r(C)}
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        for name, (o, n) in {"attn.qkv": (3 * C, C), "attn.proj": (C, C),
                             "mlp.fc1": (4 * C, C), "mlp.fc2": (C, 4 * C)}.items():
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = r(o, n), r(o)
        for name in ("norm1", "norm2"):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = 1 + r(C), r(C)
    return sd


def test_dino_checkpoint_bridge_round_trip(tmp_path):
    """DINO names -> port directly, and DINO names -> JAX converter ->
    params_from_jax's backbone map, give the same state dict; features
    of the loaded port model match the JAX model on those weights."""
    cfg_t = make_vit_config("vit_micro", 8, img_size=32)
    sd = _dino_state(cfg_t)
    path = tmp_path / "dino.pth"
    torch.save({"teacher": {f"module.backbone.{k}": v for k, v in sd.items()}}, path)
    port_sd = load_dino_state_dict(str(path))

    from equss_tpu.models import vit as jvit
    cfg_j = jvit.make_vit_config("vit_micro", 8, img_size=32)
    flax_params = convert_dino_torch_state({k: v.numpy() for k, v in sd.items()}, cfg_j)
    via_jax = backbone_from_flax(flax_params, cfg_t.depth)
    assert port_sd.keys() == via_jax.keys()
    for k in port_sd:
        torch.testing.assert_close(port_sd[k], via_jax[k], rtol=0, atol=0)

    vit_t = VisionTransformer(cfg_t, device="cpu")
    vit_t.load_state_dict(port_sd)
    img = np.random.RandomState(5).randn(1, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        dense_t = vit_t(torch.from_numpy(img))["dense"].numpy()
    dense_j = jvit.VisionTransformer(cfg_j).apply({"params": flax_params}, jnp.asarray(img))["dense"]
    np.testing.assert_allclose(dense_t, np.asarray(dense_j), rtol=1e-4, atol=1e-4)


_BLOCK_JAX = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'equss_tpu', 'yaml'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import pkgutil, equss_tpu_torch
for m in pkgutil.walk_packages(equss_tpu_torch.__path__, 'equss_tpu_torch.'):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'equss_tpu', 'yaml')]
assert not bad, bad
print('ok')
"""


def test_port_imports_no_jax():
    """equss_tpu_torch (every module) and chip_smoke.py import with jax,
    flax, optax, equss_tpu and yaml blocked (the card machine has no YAML
    reader)."""
    res = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    cfg = EQUSSConfig(model_type="vit_micro", hidden_dim=64,
                      pq=PQConfig(num_pq=4, num_codebook=128, embed_dim=64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EQUSS(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VisionTransformer(make_vit_config("vit_micro", 8))
    from equss_tpu_torch.core.config import load_config
    from equss_tpu_torch.models.registry import build_model

    res_cfg = load_config("configs/res_cocostuff27.yaml")
    res_cfg["model"]["pretrained"]["model_type"] = "vit_micro"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(res_cfg)
    assert build_model(res_cfg, device="cpu").device == torch.device("cpu")
    model = EQUSS(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    with pytest.raises(ValueError, match="img_pos"):      # training needs positives
        model(torch.zeros(1, 32, 32, 3), training=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
