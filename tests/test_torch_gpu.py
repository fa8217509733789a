"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from equss_tpu_torch.ops.attention import attention_qkv, attention_qkv_reference
from equss_tpu_torch.ops.pq_assign import pq_assign, pq_assign_reference
from equss_tpu_torch.ops.quantizer import normalize_vectors

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,H,n_real", [(2, 785, 6, 785), (1, 70, 2, 33),
                                          (3, 130, 12, 129)])
def test_attention_kernel_matches_plain(cuda, B, N, H, n_real):
    g = torch.Generator(device=cuda).manual_seed(B * N)
    qkv = torch.randn((B, N, 3 * 64 * H), generator=g, device=cuda).to(torch.bfloat16)
    before = attention_qkv.launches
    out = attention_qkv(qkv, H, 0.125, n_real)
    assert attention_qkv.launches == before + 1
    ref = attention_qkv_reference(qkv, H, 0.125, n_real).float()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    assert (out.float() - ref).abs().max().item() <= ulp     # 1 bf16 ulp


@pytest.mark.parametrize("mode", ["none", "l2", "z_norm"])
@pytest.mark.parametrize("exact", [True, False])
def test_pq_kernel_matches_plain(cuda, mode, exact):
    g = torch.Generator(device=cuda).manual_seed(3)
    z = 3.0 * torch.randn((1000, 8, 16), generator=g, device=cuda)
    cb = torch.randn((8, 256, 16), generator=g, device=cuda)
    cn = normalize_vectors(cb, mode).contiguous()
    idx, zn, zq = pq_assign(z, cn, cb, normalize=mode, exact=exact)
    idx_r, zn_r, zq_r = pq_assign_reference(z, cn, cb, normalize=mode, exact=exact)
    agree = (idx == idx_r).float().mean().item()
    assert agree >= (0.9999 if exact else 0.995)
    torch.testing.assert_close(zn, zn_r, rtol=1e-6, atol=1e-6)
    same = idx == idx_r
    assert torch.equal(zq[same], zq_r[same])


def test_kernels_reject_what_they_do_not_take(cuda):
    qkv = torch.zeros((1, 8, 3 * 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention_qkv(qkv, 1, 0.125)                   # head_dim 32
    with pytest.raises(TypeError):
        attention_qkv(qkv.float().reshape(1, 8, 96), 1, 0.125)
    z = torch.zeros((4, 2, 12), device=cuda)
    with pytest.raises(ValueError):
        pq_assign(z, torch.zeros((2, 128, 12), device=cuda),
                  torch.zeros((2, 128, 12), device=cuda))   # d = 12
