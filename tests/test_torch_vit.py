"""Port ViT (equss_tpu_torch/models/vit.py) vs the JAX ViT.

The JAX backbone is initialised, its params go through the weight bridge
(``equss_tpu_torch.convert.backbone_from_flax``) and both see the same
image from a numpy seed.

* f32: dense features within 1e-4 (the fidelity class of
  tests/test_vit.py), on an image whose grid differs from ``pos_grid`` so
  the bicubic pos-embed interpolation runs.
* bf16 with ``attn_bf16``: the kernel path on both sides
  (``fused_attn_min_n`` lowered as in tests/test_attention.py) — the JAX
  Pallas kernel in interpret mode, the port's wrapper taking its plain
  version — within atol 5e-2, the existing bf16 class
  (tests/test_attention.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from equss_tpu.models import vit as jvit
from equss_tpu_torch.convert import backbone_from_flax
from equss_tpu_torch.models import vit as tvit
from equss_tpu_torch.ops.resize import resize2d


def _pair(dtype_j, dtype_t, img_hw, seed=0, min_n=512, **kw):
    cfg_j = jvit.make_vit_config("vit_micro", 8, dtype=dtype_j, img_size=32, **kw)
    cfg_j = dataclasses.replace(cfg_j, fused_attn_min_n=min_n)
    cfg_t = tvit.make_vit_config("vit_micro", 8, dtype=dtype_t, img_size=32, **kw)
    cfg_t = dataclasses.replace(cfg_t, fused_attn_min_n=min_n)
    img = np.random.RandomState(seed).randn(2, *img_hw, 3).astype(np.float32)
    vit_j = jvit.VisionTransformer(cfg_j)
    params = vit_j.init(jax.random.PRNGKey(seed), jnp.asarray(img))["params"]
    vit_t = tvit.VisionTransformer(cfg_t, device="cpu")
    vit_t.load_state_dict(backbone_from_flax(params, cfg_t.depth))
    out_j = vit_j.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        out_t = vit_t(torch.from_numpy(img))
    return out_j, out_t


def test_vit_f32_dense_matches_jax_with_pos_interpolation():
    out_j, out_t = _pair(jnp.float32, torch.float32, (48, 40))   # 6x5 grid vs 4x4
    dense_t = out_t["dense"].numpy()
    assert dense_t.shape == (2, 6, 5, 32)
    np.testing.assert_allclose(dense_t, np.asarray(out_j["dense"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out_t["tokens"].numpy(), np.asarray(out_j["tokens"]),
                               rtol=1e-4, atol=1e-4)


def test_vit_bf16_kernel_path_matches_jax_pallas(monkeypatch):
    calls = []
    wrapper = tvit.attention_qkv
    monkeypatch.setattr(tvit, "attention_qkv",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    out_j, out_t = _pair(jnp.bfloat16, torch.bfloat16, (64, 64), seed=1,
                         min_n=16, attn_bf16=True)
    assert len(calls) == 2                               # one per block
    a = np.asarray(out_j["dense"], np.float32)
    b = out_t["dense"].float().numpy()
    assert out_t["dense"].dtype == torch.bfloat16
    np.testing.assert_allclose(b, a, atol=5e-2)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resize2d_matches_jax(method):
    from equss_tpu.ops.resize import resize2d as jresize

    x = np.random.RandomState(4).randn(2, 7, 9, 3).astype(np.float32)
    sf = (15.1 / 7, 4.1 / 9) if method == "bicubic" else None
    a = np.asarray(jresize(jnp.asarray(x), (15, 4), method, scale_factor=sf))
    b = resize2d(torch.from_numpy(x), (15, 4), method, scale_factor=sf).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_vit_presets_and_gelu_rule():
    cfg = tvit.make_vit_config("vit_small", 8)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads) == (384, 12, 6)
    assert not cfg.gelu_approximate
    cfg = tvit.make_vit_config("vit_base", 8, dtype=torch.bfloat16)
    assert (cfg.embed_dim, cfg.num_heads) == (768, 12) and cfg.gelu_approximate
    assert not tvit.make_vit_config("vit_micro", 8, dtype=torch.bfloat16,
                                    gelu="erf").gelu_approximate
    with pytest.raises(ValueError):
        tvit.make_vit_config("vit_huge", 8)
