"""LayerNorm, and residual add + LayerNorm, over bf16 rows with f32
statistics.

Counterparts of ``equss_tpu/ops/layernorm.py::fused_layernorm`` and
``::fused_add_layernorm``.  The kernels are ``csrc/layernorm.cu`` (CUDA
C++ for sm_90a); ``layernorm_reference`` and ``add_layernorm_reference``
are their plain PyTorch versions.

Each is a PyTorch custom op (``equss::layernorm``,
``equss::add_layernorm``): the plain version is its CPU implementation,
the kernel its CUDA one, and a fake implementation gives the outputs'
shapes for ``torch.export``.  The wrappers take the plain version for
tensors on the CPU and the kernel for tensors on CUDA; they never fall
back from one to the other.

As in the JAX package, whose custom VJP differentiates the reference
formula with XLA ops, each op's backward (``register_autograd``)
recomputes the plain version under autograd: the TPU kernels have no
backward kernel, and the frozen backbone never takes this backward on
the training path.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from equss_tpu_torch.core import trace
from equss_tpu_torch.device import check_cuda_tensor, launch_stream, on_device
from equss_tpu_torch.ops import _build

KERNEL_MAX_C = 1024


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """Plain version: LayerNorm over the last axis with f32 mean, biased
    f32 variance of the centred row and rsqrt(var + eps); the affine step
    in f32; the result in ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def add_layernorm_reference(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, eps: float = 1e-6
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``s = x + y`` in the residual dtype, then
    ``(s, LayerNorm(s))``; the statistics read the rounded sum."""
    s = x + y
    return s, layernorm_reference(s, scale, bias, eps)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("layernorm")
    if lib.layernorm_launch.argtypes is None:
        for fn, n_ptr in ((lib.layernorm_launch, 4), (lib.add_layernorm_launch, 6)):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 2 \
                + [ctypes.c_float, ctypes.c_void_p]
    return lib


def _check_kernel_operands(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, *others: torch.Tensor) -> int:
    """Raise unless the kernel takes these operands; returns C."""
    C = x.shape[-1]
    check_cuda_tensor(x, "x", torch.bfloat16)
    for i, t in enumerate(others):
        check_cuda_tensor(t, f"operand {i + 1}", torch.bfloat16, x.device)
        if t.shape != x.shape:
            raise ValueError(f"operands must share one shape, got {tuple(x.shape)} "
                             f"and {tuple(t.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        check_cuda_tensor(t, name, torch.float32, x.device)
        if t.shape != (C,):
            raise ValueError(f"{name} must be ({C},), got {tuple(t.shape)}")
    if C % 8 or C > KERNEL_MAX_C:
        raise ValueError(f"LayerNorm kernel takes C a multiple of 8 up to "
                         f"{KERNEL_MAX_C}, got {C}")
    return C


@torch.library.custom_op("equss::layernorm", mutates_args=(), device_types="cpu")
def _layernorm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    return layernorm_reference(x, scale, bias, eps)


@_layernorm_op.register_kernel("cuda")
def _layernorm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    C = _check_kernel_operands(x, scale, bias)
    out = torch.empty_like(x)
    with on_device(x):
        err = _kernel_lib().layernorm_launch(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            x.numel() // C, C, eps, launch_stream(x))
    if err:
        raise RuntimeError(f"layernorm launch failed: CUDA error {err}")
    trace.count("launch.layernorm")
    return out


@_layernorm_op.register_fake
def _layernorm_fake(x, scale, bias, eps):
    return torch.empty_like(x)


@torch.library.custom_op("equss::add_layernorm", mutates_args=(), device_types="cpu")
def _add_layernorm_op(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return add_layernorm_reference(x, y, scale, bias, eps)


@_add_layernorm_op.register_kernel("cuda")
def _add_layernorm_cuda(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    C = _check_kernel_operands(x, scale, bias, y)
    s = torch.empty_like(x)
    out = torch.empty_like(x)
    with on_device(x):
        err = _kernel_lib().add_layernorm_launch(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            s.data_ptr(), out.data_ptr(), x.numel() // C, C, eps, launch_stream(x))
    if err:
        raise RuntimeError(f"add_layernorm launch failed: CUDA error {err}")
    trace.count("launch.add_layernorm")
    return s, out


@_add_layernorm_op.register_fake
def _add_layernorm_fake(x, y, scale, bias, eps):
    return torch.empty_like(x), torch.empty_like(x)


def _reference_grads(fn, inputs, grads):
    """Gradients of the plain version ``fn`` at ``inputs`` (recomputed)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(outs, leaves, grads)


def _save_operands(ctx, inputs, output):
    *tensors, eps = inputs
    ctx.save_for_backward(*tensors)
    ctx.eps = eps


def _layernorm_backward(ctx, g):
    eps = ctx.eps
    grads = _reference_grads(
        lambda a, s, b: layernorm_reference(a, s, b, eps), ctx.saved_tensors, (g,))
    return (*grads, None)


def _add_layernorm_backward(ctx, g_sum, g_ln):
    eps = ctx.eps
    grads = _reference_grads(
        lambda a, b, s, bb: add_layernorm_reference(a, b, s, bb, eps),
        ctx.saved_tensors, (g_sum, g_ln))
    return (*grads, None)


_layernorm_op.register_autograd(_layernorm_backward, setup_context=_save_operands)
_add_layernorm_op.register_autograd(_add_layernorm_backward, setup_context=_save_operands)


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; x (..., C), scale and bias (C,) f32.
    The op ``equss::layernorm``.

    CPU tensors: the plain version.  CUDA tensors: the kernel, which takes
    contiguous bf16 rows with C a multiple of 8 up to 1024 and raises on
    anything else."""
    return _layernorm_op(x, scale, bias, eps)


def fused_add_layernorm(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) -> (x + y, LayerNorm(x + y)); x and y (..., C) of one dtype.
    The op ``equss::add_layernorm``.

    CPU tensors: the plain version.  CUDA tensors: the kernel, on the
    operands ``fused_layernorm``'s kernel takes."""
    return _add_layernorm_op(x, y, scale, bias, eps)
