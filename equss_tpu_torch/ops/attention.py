"""Multi-head attention straight off the packed qkv projection.

Counterpart of ``equss_tpu/ops/attention.py::fused_attention_qkv``.  The
kernel is ``csrc/attention_qkv.cu`` (CUDA C++ for sm_90a);
``attention_qkv_reference`` is its plain PyTorch version, the same
arithmetic written with whole-tensor ops.  ``attention_qkv`` takes the
plain version for a tensor on the CPU and the kernel for a tensor on
CUDA; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from equss_tpu_torch.device import check_cuda_tensor, launch_stream
from equss_tpu_torch.ops import _build

KERNEL_HEAD_DIM = 64


def _split_heads(qkv: torch.Tensor, num_heads: int, n_real: Optional[int]):
    B, N, C3 = qkv.shape
    if C3 % 3 or (C3 // 3) % num_heads:
        raise ValueError(f"qkv width {C3} is not 3 * num_heads * head_dim")
    n_real = N if n_real is None else int(n_real)
    if not 1 <= n_real <= N:
        raise ValueError(f"n_real {n_real} outside [1, {N}]")
    return B, N, C3 // 3, C3 // 3 // num_heads, n_real


def attention_qkv_reference(qkv: torch.Tensor, num_heads: int, scale: float,
                            n_real: Optional[int] = None) -> torch.Tensor:
    """Plain version: (B, N, 3C) in channel order [q|k|v] x [head] x [hd]
    -> (B, N, C).  f32 logits and softmax, keys >= n_real masked to
    -1e30, probabilities cast to the input dtype before the value
    product, 1/sum applied after it in f32."""
    B, N, C, hd, n_real = _split_heads(qkv, num_heads, n_real)
    x = qkv.reshape(B, N, 3, num_heads, hd)
    q, k, v = (x[:, :, i].transpose(1, 2).float() for i in range(3))
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale      # (B, H, N, N)
    if n_real != N:
        logits[..., n_real:] = -1e30
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    r = 1.0 / p.sum(-1, keepdim=True)
    out = torch.matmul(p.to(qkv.dtype).float(), v) * r
    return out.transpose(1, 2).reshape(B, N, C).to(qkv.dtype)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("attention_qkv")
    fn = lib.attention_qkv_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
    return lib


def attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                  n_real: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v for every head of the packed (B, N, 3C)
    qkv tensor -> (B, N, C); keys at index >= ``n_real`` are masked.

    CPU tensor: the plain version.  CUDA tensor: the kernel, which takes
    contiguous bf16 with head_dim 64 and raises on anything else."""
    B, N, C, hd, n_real = _split_heads(qkv, num_heads, n_real)
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads, scale, n_real)
    check_cuda_tensor(qkv, "qkv", torch.bfloat16)
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(
            f"attention kernel takes head_dim {KERNEL_HEAD_DIM}, got {hd}")
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    err = _kernel_lib().attention_qkv_launch(
        qkv.data_ptr(), out.data_ptr(), B, N, num_heads, n_real, scale,
        launch_stream(qkv))
    if err:
        raise RuntimeError(f"attention_qkv launch failed: CUDA error {err}")
    attention_qkv.launches += 1
    return out


attention_qkv.launches = 0
