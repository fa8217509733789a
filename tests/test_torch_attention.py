"""Port attention (equss_tpu_torch/ops/attention.py) vs the JAX kernel.

The port's plain version ``attention_qkv_reference`` (what the wrapper
runs on the CPU, and what the CUDA kernel is held against on the card)
against ``equss_tpu.ops.attention.fused_attention_qkv``, which runs its
Pallas kernel in interpret mode here.  Same bf16 inputs from a numpy seed.

Tolerance: one bf16 ulp at the output's scale (2**(floor(log2 max|out|)
- 7)).  Both sides take f32 logits, a two-pass softmax against the final
max, bf16 probabilities and the 1/sum after the value product; only the
f32 summation order differs, which moves an output by at most the one
bf16 rounding step it can land on.  That is tighter than the existing
atol=1.2e-2 class of tests/test_attention.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from equss_tpu.ops.attention import fused_attention_qkv
from equss_tpu_torch.ops.attention import attention_qkv, attention_qkv_reference


def _bf16_ulp(ref: np.ndarray) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _inputs(B, N, H, hd, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, 3 * H * hd).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("shape,n_real", [
    ((2, 785, 6, 64), None),        # ViT-S/8 at 224^2
    ((1, 5, 2, 64), None),          # shorter than any tile
    ((2, 200, 2, 64), 130),         # keys >= n_real masked
])
def test_attention_qkv_reference_matches_jax_kernel(shape, n_real):
    B, N, H, hd = shape
    qkv_j, qkv_t = _inputs(B, N, H, hd, seed=sum(shape))
    scale = hd ** -0.5
    ref = np.asarray(fused_attention_qkv(qkv_j, num_heads=H, scale=scale,
                                         n_real=n_real), np.float32)
    out = attention_qkv_reference(qkv_t, H, scale, n_real).float().numpy()
    assert out.shape == ref.shape == (B, N, H * hd)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_bf16_ulp(ref))


def test_attention_qkv_wrapper_takes_plain_version_on_cpu():
    qkv_j, qkv_t = _inputs(1, 40, 2, 64, seed=3)
    before = attention_qkv.launches
    out = attention_qkv(qkv_t, 2, 0.125, n_real=33)
    assert attention_qkv.launches == before          # no kernel launch
    torch.testing.assert_close(out, attention_qkv_reference(qkv_t, 2, 0.125, 33),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        attention_qkv(qkv_t, 2, 0.125, n_real=41)
