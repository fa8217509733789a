"""Fused product-quantization assignment: normalise -> distances ->
first-minimum argmin -> codeword gather, for all M subspaces at once.

Counterpart of ``equss_tpu/ops/pq_pallas.py::pq_assign_pallas``.  The
kernel is ``csrc/pq_assign.cu`` (CUDA C++ for sm_90a);
``pq_assign_reference`` is its plain PyTorch version.  ``pq_assign``
takes the plain version for tensors on the CPU and the kernel for
tensors on CUDA; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from equss_tpu_torch.device import check_cuda_tensor, launch_stream
from equss_tpu_torch.ops import _build

MODES = ("none", "l2", "z_norm", "z_trainable")
KERNEL_SUB_DIMS = (8, 16, 32)


def normalize_vectors(z: torch.Tensor, mode: str,
                      z_mean: Optional[torch.Tensor] = None,
                      z_std: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalise the last axis (one subspace vector), the formulae of
    ``equss_tpu.ops.quantizer.normalize_vectors`` and of the kernel:
    l2 ``z / max(sqrt(sum z^2), 1e-12)``; z_norm ``(z - mean) /
    (sqrt(unbiased var) + 1e-5)``; z_trainable ``(z - z_mean) /
    (z_std + 1e-5)`` with per-subspace (M, d) statistics."""
    if mode == "none":
        return z
    if mode == "l2":
        return z / torch.sqrt((z * z).sum(-1, keepdim=True)).clamp_min(1e-12)
    if mode == "z_norm":
        d = z.shape[-1]
        xc = z - z.sum(-1, keepdim=True) / d
        var = (xc * xc).sum(-1, keepdim=True) / max(d - 1, 1)
        return xc / (torch.sqrt(var) + 1e-5)
    if mode == "z_trainable":
        if z_mean is None or z_std is None:
            raise ValueError("z_trainable requires z_mean and z_std")
        return (z - z_mean) / (z_std + 1e-5)
    raise ValueError(f"Unsupported normalize mode {mode}")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 and back."""
    return x.to(torch.bfloat16).float()


def pq_assign_reference(
    z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor, *,
    normalize: str = "none", z_mean: Optional[torch.Tensor] = None,
    z_std: Optional[torch.Tensor] = None, exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the (n, M, K) distances are formed in
    full.  Returns ``(idx (n, M) int32, z_norm (n, M, d), z_q (n, M, d))``,
    both f32."""
    z = z.float()
    c_norm = c_norm.float()
    K = c_norm.shape[1]
    zn = normalize_vectors(z, normalize, z_mean, z_std)
    z_sq = (zn * zn).sum(-1, keepdim=True)                      # (n, M, 1)
    c_sq = (c_norm * c_norm).sum(-1)                            # (M, K)
    if exact:
        cross = torch.einsum("nmd,mkd->nmk", zn, c_norm)
        dist = (z_sq + c_sq) - 2.0 * cross
        idx = dist.argmin(-1)
        zq_src = c_raw.float()
    else:
        # bf16 operands, f32 products and sums (each product of two bf16
        # values is exact in f32)
        cross = torch.einsum("nmd,mkd->nmk", _bf16(zn), _bf16(c_norm))
        if normalize == "l2" and K <= 256:
            dist = 1.0 - cross
        else:
            dist = (z_sq + c_sq) - 2.0 * cross
        if K <= 256:
            # low 8 mantissa bits carry the index: the int min is the
            # minimum with first-index tie-break
            k = torch.arange(K, dtype=torch.int32, device=z.device)
            packed = (dist.view(torch.int32) & -256) | k
            idx = packed.amin(-1) & 0xFF
        else:
            idx = dist.argmin(-1)
        zq_src = _bf16(c_raw.float())
    idx = idx.to(torch.int32)
    m = torch.arange(c_norm.shape[0], device=z.device)
    zq = zq_src[m, idx.long()]                                  # (n, M, d)
    return idx, zn, zq


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("pq_assign")
    fn = lib.pq_assign_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    return lib


def pq_assign(
    z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor, *,
    normalize: str = "none", z_mean: Optional[torch.Tensor] = None,
    z_std: Optional[torch.Tensor] = None, exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused normalise + assign + gather.

    z (n, M, d) raw or pre-normalised; c_norm (M, K, d) the normalised
    codebook the distances use; c_raw (M, K, d) the codebook gathered
    from; z_mean/z_std (M, d) for ``z_trainable``.  Returns ``(idx (n, M)
    int32, z_norm (n, M, d) f32, z_q (n, M, d) f32)``.

    CPU tensors: the plain version.  CUDA tensors: the kernel, which
    takes contiguous f32 with d in (8, 16, 32) and raises on anything
    else."""
    if normalize not in MODES:
        raise ValueError(f"Unsupported normalize mode {normalize}")
    if normalize == "z_trainable" and (z_mean is None or z_std is None):
        raise ValueError("z_trainable requires z_mean and z_std")
    n, M, d = z.shape
    K = c_norm.shape[1]
    if c_norm.shape != (M, K, d) or c_raw.shape != (M, K, d):
        raise ValueError(f"codebooks must be ({M}, K, {d}), got "
                         f"{tuple(c_norm.shape)} and {tuple(c_raw.shape)}")
    if z.device.type == "cpu":
        return pq_assign_reference(z, c_norm, c_raw, normalize=normalize,
                                   z_mean=z_mean, z_std=z_std, exact=exact)
    check_cuda_tensor(z, "z", torch.float32)
    for name, t in (("c_norm", c_norm), ("c_raw", c_raw)):
        check_cuda_tensor(t, name, torch.float32, z.device)
    stats = (None, None)
    if normalize == "z_trainable":
        for name, t in (("z_mean", z_mean), ("z_std", z_std)):
            check_cuda_tensor(t, name, torch.float32, z.device)
            if t.shape != (M, d):
                raise ValueError(f"{name} must be ({M}, {d})")
        stats = (z_mean.data_ptr(), z_std.data_ptr())
    if d not in KERNEL_SUB_DIMS:
        raise ValueError(f"PQ kernel takes d in {KERNEL_SUB_DIMS}, got {d}")
    idx = torch.empty((n, M), dtype=torch.int32, device=z.device)
    zn = torch.empty_like(z)
    zq = torch.empty_like(z)
    err = _kernel_lib().pq_assign_launch(
        z.data_ptr(), c_norm.data_ptr(), c_raw.data_ptr(), *stats,
        idx.data_ptr(), zn.data_ptr(), zq.data_ptr(), n, M, K, d,
        MODES.index(normalize), int(exact), launch_stream(z))
    if err:
        raise RuntimeError(f"pq_assign launch failed: CUDA error {err}")
    pq_assign.launches += 1
    return idx, zn, zq


pq_assign.launches = 0
