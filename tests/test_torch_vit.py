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
* ``want_attn`` and ``n_last``: the attention maps and the intermediates
  of the last blocks within 1e-4 in f32; in bf16 with ``attn_bf16`` the
  maps come from the plain path (the kernel is not launched), within the
  bf16 class; under ``fused_ln`` the pending residual folds into the
  final norm of every intermediate.
* ``ln_stats: bf16``: bf16 LayerNorm statistics within the bf16 class of
  JAX's ``BF16StatsLayerNorm``, and the JAX package's precedence
  (``fused_ln``, then bf16 statistics, then f32).
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


def _pair(dtype_j, dtype_t, img_hw, seed=0, min_n=512, fused_ln=False, call=None, **kw):
    cfg_j = jvit.make_vit_config("vit_micro", 8, dtype=dtype_j, img_size=32, **kw)
    cfg_j = dataclasses.replace(cfg_j, fused_attn_min_n=min_n, fused_ln=fused_ln)
    cfg_t = tvit.make_vit_config("vit_micro", 8, dtype=dtype_t, img_size=32, **kw)
    cfg_t = dataclasses.replace(cfg_t, fused_attn_min_n=min_n, fused_ln=fused_ln)
    img = np.random.RandomState(seed).randn(2, *img_hw, 3).astype(np.float32)
    vit_j = jvit.VisionTransformer(cfg_j)
    params = vit_j.init(jax.random.PRNGKey(seed), jnp.asarray(img))["params"]
    vit_t = tvit.VisionTransformer(cfg_t, device="cpu")
    vit_t.load_state_dict(backbone_from_flax(params, cfg_t.depth))
    out_j = vit_j.apply({"params": params}, jnp.asarray(img), **(call or {}))
    with torch.no_grad():
        out_t = vit_t(torch.from_numpy(img), **(call or {}))
    return out_j, out_t


def _f32(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


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


def test_vit_attention_maps_and_intermediates_match_jax():
    """f32, ``want_attn`` and ``n_last=2`` (both blocks of vit_micro): each
    block's (b, H, N, N) softmax and final-normed tokens within 1e-4, the
    last intermediate is ``tokens``; ``n_last=1`` alone keeps one."""
    call = dict(want_attn=True, n_last=2)
    out_j, out_t = _pair(jnp.float32, torch.float32, (48, 40), seed=2, call=call)
    assert len(out_t["attn"]) == len(out_t["intermediates"]) == 2
    for a_t, a_j in zip(out_t["attn"], out_j["attn"]):
        assert a_t.shape == (2, 2, 31, 31) and a_t.dtype == torch.float32
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-4, atol=1e-4)
    for f_t, f_j in zip(out_t["intermediates"], out_j["intermediates"]):
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-4, atol=1e-4)
    assert out_t["intermediates"][-1] is out_t["tokens"]
    np.testing.assert_allclose(out_t["attn"][0].sum(-1).numpy(), 1.0, atol=1e-5)
    _, one = _pair(jnp.float32, torch.float32, (48, 40), seed=2)
    assert len(one["intermediates"]) == 1 and "attn" not in one
    with pytest.raises(ValueError, match="n_last"):
        tvit.VisionTransformer(tvit.make_vit_config("vit_micro", 8), device="cpu")(
            torch.zeros(1, 16, 16, 3), n_last=3)


@pytest.mark.parametrize("fused_ln", [False, True], ids=["stock", "fused_ln"])
def test_vit_bf16_attention_maps_take_the_plain_path(monkeypatch, fused_ln):
    """bf16 with ``attn_bf16`` at a token count the kernel takes: with
    ``want_attn`` no block launches it (JAX's rule: the kernel returns no
    maps), the maps are the plain path's bf16 softmax within the bf16
    class, and under ``fused_ln`` each intermediate folds the pending MLP
    residual into the final norm's add + LayerNorm, as JAX's does."""
    calls = []
    wrapper = tvit.attention_qkv
    monkeypatch.setattr(tvit, "attention_qkv",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    call = dict(want_attn=True, n_last=2)
    out_j, out_t = _pair(jnp.bfloat16, torch.bfloat16, (64, 64), seed=3, min_n=16,
                         attn_bf16=True, fused_ln=fused_ln, call=call)
    assert calls == []
    for a_t, a_j in zip(out_t["attn"], out_j["attn"]):
        assert a_t.dtype == torch.bfloat16 and a_t.shape == (2, 2, 65, 65)
        np.testing.assert_allclose(_f32(a_t), _f32(a_j), atol=2e-2)
    for f_t, f_j in zip(out_t["intermediates"], out_j["intermediates"]):
        np.testing.assert_allclose(_f32(f_t), _f32(f_j), atol=5e-2)
    # without maps the kernel runs in both blocks, as before
    _pair(jnp.bfloat16, torch.bfloat16, (64, 64), seed=3, min_n=16, attn_bf16=True,
          fused_ln=fused_ln)
    assert len(calls) == 2


def test_vit_bf16_ln_stats_matches_jax_and_precedence():
    """``ln_stats='bf16'``: dense within the bf16 class of JAX's
    ``BF16StatsLayerNorm``; the norms are ``BF16StatsLayerNorm`` only in a
    bf16 backbone without ``fused_ln``."""
    out_j, out_t = _pair(jnp.bfloat16, torch.bfloat16, (48, 40), seed=4, ln_stats="bf16")
    np.testing.assert_allclose(_f32(out_t["dense"]), _f32(out_j["dense"]), atol=5e-2)
    out_f = _pair(jnp.bfloat16, torch.bfloat16, (48, 40), seed=4)[1]
    assert not torch.equal(out_t["dense"], out_f["dense"])
    kinds = {}
    for name, dtype, fused in (("bf16", torch.bfloat16, False), ("f32", torch.float32, False),
                               ("fused", torch.bfloat16, True)):
        cfg = dataclasses.replace(tvit.make_vit_config("vit_micro", 8, dtype=dtype,
                                                       ln_stats="bf16"), fused_ln=fused)
        kinds[name] = type(tvit.VisionTransformer(cfg, device="cpu").norm)
    assert kinds == {"bf16": tvit.BF16StatsLayerNorm, "f32": tvit.LayerNorm,
                     "fused": tvit.FusedLayerNorm}
    with pytest.raises(ValueError, match="ln_stats"):
        tvit.make_vit_config("vit_micro", 8, ln_stats="f16")
