"""Multi-head attention, straight off the packed qkv projection or on
separate q, k and v.

Counterparts of ``equss_tpu/ops/attention.py::fused_attention_qkv`` and
``::fused_attention``.  Both kernels are entries of
``csrc/attention_qkv.cu`` (CUDA C++ for sm_90a);
``attention_qkv_reference`` and ``fused_attention_reference`` are their
plain PyTorch versions, the same arithmetic written with whole-tensor
ops.

Each is a PyTorch custom op (``equss::attention_qkv``,
``equss::attention``): the plain version is its CPU implementation, the
kernel its CUDA one, and a fake implementation gives the output's shape,
so that ``torch.export`` records the op itself in a graph and an
exported artifact launches the kernel.  The wrappers take the plain
version for tensors on the CPU and the kernel for tensors on CUDA; they
never fall back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from equss_tpu_torch.core import trace
from equss_tpu_torch.device import check_cuda_tensor, launch_stream, on_device
from equss_tpu_torch.ops import _build

KERNEL_HEAD_DIM = 64                 # the packed entry
KERNEL_HEAD_DIMS = (32, 64)          # the separate-q/k/v entry


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
    out = _attention_plain(x[:, :, 0], x[:, :, 1], x[:, :, 2], scale, n_real)
    return out.reshape(B, N, C)


def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, n_real: int) -> torch.Tensor:
    """(B, N, H, hd) q, k, v -> (B, N, H, hd) in their dtype: f32 logits
    and softmax, keys >= n_real masked to -1e30, probabilities cast to the
    input dtype before the value product, 1/sum applied after it in f32."""
    dtype = q.dtype
    q, k, v = (t.transpose(1, 2).float() for t in (q, k, v))   # (B, H, N, hd)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale      # (B, H, N, N)
    if n_real != logits.shape[-1]:
        logits[..., n_real:] = -1e30
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    r = 1.0 / p.sum(-1, keepdim=True)
    out = torch.matmul(p.to(dtype).float(), v) * r
    return out.transpose(1, 2).to(dtype, memory_format=torch.contiguous_format)


_LAUNCH_ERRORS = {-1: "libcuda has no cuTensorMapEncodeTiled",
                  -2: "libcuda refused the tensor map"}


def _check_launch(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + _LAUNCH_ERRORS.get(err, f"CUDA error {err}"))


def _check_scale(scale: float) -> None:
    """The kernel takes its running row max on unscaled logits, which is
    the max of the scaled ones only for scale > 0 (every caller passes
    head_dim ** -0.5)."""
    if not scale > 0:
        raise ValueError(f"attention kernel takes scale > 0, got {scale}")


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("attention_qkv")
    fn = lib.attention_qkv_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
    return lib


@torch.library.custom_op("equss::attention_qkv", mutates_args=(), device_types="cpu")
def _attention_qkv_op(qkv: torch.Tensor, num_heads: int, scale: float,
                      n_real: int) -> torch.Tensor:
    return attention_qkv_reference(qkv, num_heads, scale, n_real)


@_attention_qkv_op.register_kernel("cuda")
def _attention_qkv_cuda(qkv: torch.Tensor, num_heads: int, scale: float,
                        n_real: int) -> torch.Tensor:
    B, N, C, hd, n_real = _split_heads(qkv, num_heads, n_real)
    check_cuda_tensor(qkv, "qkv", torch.bfloat16)
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(
            f"attention kernel takes head_dim {KERNEL_HEAD_DIM}, got {hd}")
    _check_scale(scale)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    with on_device(qkv):
        err = _kernel_lib().attention_qkv_launch(
            qkv.data_ptr(), out.data_ptr(), B, N, num_heads, n_real, scale,
            launch_stream(qkv))
    _check_launch("attention_qkv", err)
    trace.count("launch.attention_qkv")
    return out


@_attention_qkv_op.register_fake
def _attention_qkv_fake(qkv: torch.Tensor, num_heads: int, scale: float,
                        n_real: int) -> torch.Tensor:
    B, N, C3 = qkv.shape
    return qkv.new_empty((B, N, C3 // 3))


def attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                  n_real: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v for every head of the packed (B, N, 3C)
    qkv tensor -> (B, N, C); keys at index >= ``n_real`` are masked.
    The op ``equss::attention_qkv``.

    CPU tensor: the plain version.  CUDA tensor: the kernel, which takes
    contiguous, 16-byte aligned bf16 with head_dim 64 and scale > 0 and
    raises on anything else.  That is all its TMA loads need: the kernel
    builds the token and batch strides from the shape, and with head_dim
    64 they are multiples of 16 bytes."""
    n_real = _split_heads(qkv, num_heads, n_real)[-1]
    return _attention_qkv_op(qkv, num_heads, scale, n_real)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              *, scale: float) -> torch.Tensor:
    """Plain version of the separate-q/k/v kernel: (B, N, H, hd) each ->
    (B, N, H, hd), the arithmetic of ``attention_qkv_reference`` with
    every key a real one."""
    return _attention_plain(q, k, v, scale, q.shape[1])


@torch.library.custom_op("equss::attention", mutates_args=(), device_types="cpu")
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    return fused_attention_reference(q, k, v, scale=scale)


@_attention_op.register_kernel("cuda")
def _attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(t, name, torch.bfloat16, q.device)
    B, N, H, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {hd}")
    _check_scale(scale)
    out = torch.empty_like(q)
    lib = _kernel_lib()
    fn = lib.attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
    with on_device(q):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, N, H, hd, N, scale, launch_stream(q))
    _check_launch("fused_attention", err)
    trace.count("launch.attention")
    return out


@_attention_op.register_fake
def _attention_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    return torch.empty_like(q)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for every head of separate (B, N, H, hd)
    q, k and v -> (B, N, H, hd).  The op ``equss::attention``.

    CPU tensors: the plain version.  CUDA tensors: the kernel, which takes
    contiguous, 16-byte aligned bf16 of one shape with head_dim 32 or 64
    and scale > 0 and raises on anything else (which covers its TMA
    loads, as for ``attention_qkv``)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share one (B, N, H, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _attention_op(q, k, v, scale)


ATTENTION_INPUTS = ("randn", "late_max", "late_max_near", "nan_neighbour")


def attention_test_input(x: torch.Tensor, kind: str, n_real: int) -> torch.Tensor:
    """Inputs that hold the kernels to their plain versions where the
    one-pass softmax departs from them, made from a standard-normal f32
    ``x`` of shape (B, N, 3, H, hd), q | k | v, which is changed in place;
    returned as bf16.  With scale = head_dim ** -0.5:

    * ``randn``: ``x`` as it is;
    * ``late_max``: q's entries 1 + N(0, 0.25), the key at ``n_real - 1``
      (in the last, ragged key tile for n_real = 785) all 12 / sqrt(hd),
      so every row's largest logit (~12) sits there, ~8 above the rest:
      every earlier tile's bf16(p) is taken against a running max far
      below the final one, and a missing rescale shows;
    * ``late_max_near``: the same with that logit ~6.5, ~3 above the
      rest: the earlier tiles carry most of the output, so their bf16(p)
      rounding shows against the bar;
    * ``nan_neighbour``: every batch item after the first all NaN: the
      first item's rows past N must never be read from the second."""
    hd = x.shape[-1]
    if kind in ("late_max", "late_max_near"):
        x[:, :, 0] = 1 + 0.5 * x[:, :, 0]
        x[:, n_real - 1, 1] = (12.0 if kind == "late_max" else 6.5) / hd ** 0.5
    elif kind == "nan_neighbour":
        x[1:] = float("nan")
    elif kind != "randn":
        raise ValueError(f"attention input kind {kind!r} not in {ATTENTION_INPUTS}")
    return x.to(torch.bfloat16)
