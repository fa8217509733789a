"""Port LayerNorm kernels, separate-q/k/v attention and the ``fused_ln``
ViT vs the JAX package.

* ``fused_layernorm``: the port's plain version (what the wrapper runs on
  the CPU and what the CUDA kernel is held against on the card) against
  ``equss_tpu.ops.layernorm.fused_layernorm`` with its Pallas kernel in
  interpret mode.  Both take f32 statistics of the same bf16 row; only the
  order of the f32 sums differs, which can move an output across one
  bf16 rounding step.  Tolerance: at most 0.1% of elements differ, each by
  at most one bf16 ulp of max(|out|, |bias|) (where the affine terms
  cancel, the output is far smaller than the terms that carry the f32
  error).
* ``fused_add_layernorm``: the bf16 sum bit-equal; LayerNorm of it as
  above.  Its statistics read the ROUNDED sum (``_add_ln_kernel:47-49``).
  The interpreted JAX kernel does not do so on the CPU: XLA's
  ``xla_allow_excess_precision`` keeps the f32 sum, which moves about 30%
  of outputs by one ulp.  So the LayerNorm half is held against the JAX
  kernel applied to the JAX add kernel's own rounded sum.
* Gradients against the JAX custom VJPs (both differentiate the reference
  formula): scale and bias within 1e-5 of their largest magnitude (f32
  sums over rows in another order); x and y, bf16 cotangents, within one
  bf16 ulp of their largest magnitude.
* ``fused_attention``: at the JAX test shapes, within one bf16 ulp of the
  output's scale (see tests/test_torch_attention.py).
* vit_micro with ``fused_ln=True`` against JAX with ``fused_ln=True`` and
  against the port's stock path: atol 5e-2, the bf16 class of
  tests/test_attention.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from equss_tpu.ops.attention import fused_attention as j_fused_attention
from equss_tpu.ops.layernorm import fused_add_layernorm as j_add_ln
from equss_tpu.ops.layernorm import fused_layernorm as j_ln
from equss_tpu_torch.convert import backbone_from_flax
from equss_tpu_torch.models import vit as tvit
from equss_tpu_torch.ops import launch_counts
from equss_tpu_torch.ops.attention import fused_attention, fused_attention_reference
from equss_tpu_torch.ops.layernorm import (
    add_layernorm_reference,
    fused_add_layernorm,
    fused_layernorm,
    layernorm_reference,
)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


def _ln_inputs(rows, C, seed):
    rng = np.random.RandomState(seed)
    x = (3 * rng.randn(rows, C) + 1).astype(np.float32)
    y = rng.randn(rows, C).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    w = rng.randn(rows, C).astype(np.float32)               # output cotangent
    return x, y, scale, bias, w


def _assert_ln_close(out: np.ndarray, ref: np.ndarray, bias: np.ndarray):
    diff = np.abs(out - ref)
    assert np.mean(diff > 0) <= 1e-3, np.mean(diff > 0)
    assert (diff <= _bf16_ulp(np.maximum(np.abs(ref), np.abs(bias)))).all()


@pytest.mark.parametrize("rows,C", [(300, 384), (70, 32), (40, 768)])
def test_layernorm_plain_matches_jax_kernel(rows, C):
    x, y, scale, bias, w = _ln_inputs(rows, C, seed=C)
    xj, yj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    xt, yt = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    before = launch_counts()["layernorm"], launch_counts()["add_layernorm"]

    ref = np.asarray(j_ln(xj, jnp.asarray(scale), jnp.asarray(bias)), np.float32)
    out = fused_layernorm(xt, st, bt)
    assert out.dtype == torch.bfloat16
    _assert_ln_close(out.float().numpy(), ref, bias)

    s_j, _ = j_add_ln(xj, yj, jnp.asarray(scale), jnp.asarray(bias))
    ref2 = np.asarray(j_ln(s_j, jnp.asarray(scale), jnp.asarray(bias)), np.float32)
    s_t, out2 = fused_add_layernorm(xt, yt, st, bt)
    np.testing.assert_array_equal(s_t.float().numpy(), np.asarray(s_j, np.float32))
    _assert_ln_close(out2.float().numpy(), ref2, bias)
    # the wrappers took their plain versions: no kernel launched
    assert (launch_counts()["layernorm"], launch_counts()["add_layernorm"]) == before
    torch.testing.assert_close(out, layernorm_reference(xt, st, bt), rtol=0, atol=0)
    torch.testing.assert_close(out2, add_layernorm_reference(xt, yt, st, bt)[1],
                               rtol=0, atol=0)


def _assert_grads_close(got, want, bf16_cotangent):
    for g, r, is_bf16 in zip(got, want, bf16_cotangent):
        g = g.float().numpy()
        r = np.asarray(r, np.float32)
        peak = np.abs(r).max()
        tol = 2.0 ** (np.floor(np.log2(peak)) - 7) if is_bf16 else 1e-5 * peak
        np.testing.assert_allclose(g, r, rtol=0, atol=tol)


@pytest.mark.parametrize("rows,C", [(120, 384), (33, 32)])
def test_layernorm_gradients_match_jax_vjp(rows, C):
    x, y, scale, bias, w = _ln_inputs(rows, C, seed=rows)
    xj, yj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    sj, bj = jnp.asarray(scale), jnp.asarray(bias)

    def loss_j(a, s, b):
        return jnp.sum(j_ln(a, s, b).astype(jnp.float32) * w)

    def loss_add_j(a, c, s, b):
        t, o = j_add_ln(a, c, s, b)
        return jnp.sum(o.astype(jnp.float32) * w) + 0.3 * jnp.sum(t.astype(jnp.float32))

    leaves = [torch.from_numpy(v).requires_grad_() for v in (scale, bias)]
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    (fused_layernorm(xt, *leaves).float() * torch.from_numpy(w)).sum().backward()
    _assert_grads_close([xt.grad, *(t.grad for t in leaves)],
                        jax.grad(loss_j, argnums=(0, 1, 2))(xj, sj, bj),
                        (True, False, False))

    leaves = [torch.from_numpy(v).requires_grad_() for v in (scale, bias)]
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    yt = torch.from_numpy(y).bfloat16().requires_grad_()
    s_t, o_t = fused_add_layernorm(xt, yt, *leaves)
    ((o_t.float() * torch.from_numpy(w)).sum() + 0.3 * s_t.float().sum()).backward()
    _assert_grads_close([xt.grad, yt.grad, *(t.grad for t in leaves)],
                        jax.grad(loss_add_j, argnums=(0, 1, 2, 3))(xj, yj, sj, bj),
                        (True, True, False, False))


@pytest.mark.parametrize("shape", [(2, 785, 6, 64), (1, 1601, 2, 64),
                                   (1, 5, 2, 64), (2, 128, 1, 32)])
def test_fused_attention_plain_matches_jax_kernel(shape):
    B, N, H, hd = shape
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, N, H, hd).astype(np.float32) for _ in range(3))
    scale = hd ** -0.5
    ref = np.asarray(j_fused_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                       scale=scale), np.float32)
    before = launch_counts()["attention"]
    qt, kt, vt = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    out = fused_attention(qt, kt, vt, scale=scale)
    assert launch_counts()["attention"] == before
    assert out.shape == (B, N, H, hd) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out, fused_attention_reference(qt, kt, vt, scale=scale),
                               rtol=0, atol=0)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))
    with pytest.raises(ValueError):
        fused_attention(qt, kt[:, :-1], vt, scale=scale)


def test_vit_fused_ln_matches_jax_and_stock():
    from equss_tpu.models import vit as jvit

    cfg_j = jvit.make_vit_config("vit_micro", 8, dtype=jnp.bfloat16, attn_bf16=True)
    cfg_t = tvit.make_vit_config("vit_micro", 8, dtype=torch.bfloat16, attn_bf16=True)
    img = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    vit_j = jvit.VisionTransformer(dataclasses.replace(cfg_j, fused_ln=True))
    params = vit_j.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"]
    ref = np.asarray(vit_j.apply({"params": params}, jnp.asarray(img))["dense"], np.float32)

    sd = backbone_from_flax(params, cfg_t.depth)
    outs = {}
    for fused in (True, False):
        vit_t = tvit.VisionTransformer(dataclasses.replace(cfg_t, fused_ln=fused), device="cpu")
        vit_t.load_state_dict(sd)                       # same names either way
        assert isinstance(vit_t.blocks[0].norm1, tvit.FusedLayerNorm) == fused
        with torch.no_grad():
            outs[fused] = vit_t(torch.from_numpy(img))["dense"]
    assert outs[True].dtype == torch.bfloat16
    np.testing.assert_allclose(outs[True].float().numpy(), ref, atol=5e-2)
    np.testing.assert_allclose(outs[True].float().numpy(), outs[False].float().numpy(),
                               atol=5e-2)

    # the one gate: f32 keeps the stock norms; a wider operand raises
    f32 = tvit.VisionTransformer(dataclasses.replace(
        tvit.make_vit_config("vit_micro", 8), fused_ln=True), device="cpu")
    assert not isinstance(f32.blocks[0].norm1, tvit.FusedLayerNorm)
    norm = tvit.FusedLayerNorm(32, 1e-6, torch.bfloat16)
    with pytest.raises(TypeError):
        norm(torch.zeros(2, 32))
