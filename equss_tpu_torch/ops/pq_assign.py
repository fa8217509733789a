"""Fused product-quantization assignment: normalise -> distances ->
first-minimum argmin -> codeword gather, for all M subspaces at once.

Counterpart of ``equss_tpu/ops/pq_pallas.py::pq_assign_pallas``.  The
kernel is ``csrc/pq_assign.cu`` (CUDA C++ for sm_90a);
``pq_assign_reference`` is its plain PyTorch version.  It is the PyTorch
custom op ``equss::pq_assign``: the plain version is its CPU
implementation, the kernel its CUDA one, and a fake implementation gives
the outputs' shapes for ``torch.export``.  ``pq_assign`` takes the plain
version for tensors on the CPU and the kernel for tensors on CUDA; it
never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from equss_tpu_torch.device import check_cuda_tensor, launch_stream, on_device
from equss_tpu_torch.ops import _build

MODES = ("none", "l2", "z_norm", "z_trainable")
NARROW_SUB_DIMS = (8, 16, 32)
KERNEL_SMEM_BYTES = 232448        # shared memory one block can use on sm_90
KERNEL_STAGE_BYTES = 43008        # the fast narrow body's staging tiles


def kernel_domain_error(d: int, K: int, exact: bool) -> Optional[str]:
    """Why the CUDA kernel does not take subspaces of width ``d`` with
    ``K`` codewords, or None where it does (the domain stated in
    ``csrc/pq_assign.cu``'s header): every d with d % 8 == 0 and every
    K >= 1, in both modes (``exact`` changes only which body runs,
    ``kernel_body``)."""
    if d < 8 or d % 8:
        return f"PQ kernel takes d % 8 == 0, got d = {d}"
    if K < 1:
        return f"PQ kernel needs K >= 1, got {K}"
    return None


def kernel_body(d: int, K: int, exact: bool) -> str:
    """Which body of the kernel runs a shape inside its domain, by the
    rule of ``csrc/pq_assign.cu``: ``narrow`` for d in (8, 16, 32) where
    one subspace's codebooks fit a block's shared memory ((8d + 4) K bytes
    in exact mode, (4d + 4) roundup(K, 256 / d) beside 43 008 bytes of
    staging tiles in fast mode), else ``wide``, which streams the codebook
    through shared memory in tiles."""
    if d not in NARROW_SUB_DIMS:
        return "wide"
    chunk = 256 // d
    need = (8 * d + 4) * K if exact \
        else (4 * d + 4) * (-(-K // chunk) * chunk) + KERNEL_STAGE_BYTES
    return "narrow" if need <= KERNEL_SMEM_BYTES else "wide"


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
            + [ctypes.c_void_p] * 2
        lib.pq_assign_workspace_bytes.restype = ctypes.c_size_t
        lib.pq_assign_workspace_bytes.argtypes = [ctypes.c_int] * 4
        lib.pq_assign_wide_config.restype = ctypes.c_int
        lib.pq_assign_wide_config.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def kernel_workspace(z: torch.Tensor, K: int, exact: bool) -> Optional[torch.Tensor]:
    """The device workspace a kernel launch on ``z`` (n, M, d) needs (the
    wide bodies' codeword squared norms, and in fast mode the bf16
    codebook, written by their pre-passes), allocated on ``z``'s device;
    None where it needs none."""
    _, M, d = z.shape
    nbytes = _kernel_lib().pq_assign_workspace_bytes(M, K, d, int(exact))
    return torch.empty(nbytes, dtype=torch.uint8, device=z.device) if nbytes else None


def wide_config(n: int, M: int, K: int, d: int, normalize: str, exact: bool) -> dict:
    """A wide body's launch on the current card: the blocks of its main
    kernel, the resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), its dynamic shared
    memory, in exact mode into how many codeword ranges the rows' tiles are
    split (1 in fast mode) and whether the body runs ``fused`` (it
    normalises its rows and gathers their codewords itself: one block per
    row tile, no split)."""
    out = (ctypes.c_int * 5)()
    err = _kernel_lib().pq_assign_wide_config(n, M, K, d, MODES.index(normalize), int(exact), out)
    if err:
        raise RuntimeError(f"pq_assign_wide_config failed: CUDA error {err}")
    return {"blocks": out[0], "blocks_per_sm": out[1], "dynamic_smem_bytes": out[2],
            "codeword_splits": out[3], "fused": bool(out[4])}


KEY_INF = 0xFF800000              # ordered(+inf): keys at or above it mean "none"


def ordered_key(dist: torch.Tensor) -> torch.Tensor:
    """The exact wide body's order of f32 distances as int64 values in
    [0, 2**32): ``dist + 0`` (so -0 counts as +0) with its sign bit set if
    positive, all bits flipped if negative; every NaN above +inf."""
    bits = (dist.float() + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return torch.where(torch.isnan(dist), torch.full_like(key, 0xFFFFFFFF), key)


def key_argmin(dist: torch.Tensor) -> torch.Tensor:
    """Plain version of the exact wide body's minimum over the last axis:
    the least key (``ordered_key(dist)``, then the index k), as the body's
    ``atomicMin`` on ``ordered << 32 | k`` keeps it; index 0 where the key is
    at or above +inf's.  This is the strict-< scan's first minimum: NaN is
    never taken, equal distances (-0 and +0 among them) keep the lower
    index, a row with no distance below +inf gets 0.  int32 indices."""
    K = dist.shape[-1]
    k = torch.arange(K, dtype=torch.int64, device=dist.device)
    # (ordered - 2**31) * 2**32 + k keeps the unsigned order inside int64
    best = ((ordered_key(dist) - 2 ** 31) * 2 ** 32 + k).amin(-1)
    return torch.where((best >> 32) + 2 ** 31 >= KEY_INF, 0, best & 0xFFFFFFFF).to(torch.int32)


@torch.library.custom_op("equss::pq_assign", mutates_args=(), device_types="cpu")
def _pq_assign_op(z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor,
                  z_mean: Optional[torch.Tensor], z_std: Optional[torch.Tensor],
                  normalize: str, exact: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    idx, zn, zq = pq_assign_reference(z, c_norm, c_raw, normalize=normalize,
                                      z_mean=z_mean, z_std=z_std, exact=exact)
    # an op's outputs never alias its inputs: without a normalisation the
    # plain version hands an f32 z back as z_norm
    return idx, (zn.clone() if normalize == "none" else zn), zq


@_pq_assign_op.register_kernel("cuda")
def _pq_assign_cuda(z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor,
                    z_mean: Optional[torch.Tensor], z_std: Optional[torch.Tensor],
                    normalize: str, exact: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n, M, d = z.shape
    K = c_norm.shape[1]
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
    why = kernel_domain_error(d, K, exact)
    if why:
        raise ValueError(why)
    idx = torch.empty((n, M), dtype=torch.int32, device=z.device)
    zn = torch.empty_like(z)
    zq = torch.empty_like(z)
    ws = kernel_workspace(z, K, exact)
    with on_device(z):
        err = _kernel_lib().pq_assign_launch(
            z.data_ptr(), c_norm.data_ptr(), c_raw.data_ptr(), *stats,
            idx.data_ptr(), zn.data_ptr(), zq.data_ptr(), n, M, K, d,
            MODES.index(normalize), int(exact), launch_stream(z),
            None if ws is None else ws.data_ptr())
    if err:
        raise RuntimeError(f"pq_assign launch failed: CUDA error {err}")
    pq_assign.launches += 1
    return idx, zn, zq


@_pq_assign_op.register_fake
def _pq_assign_fake(z, c_norm, c_raw, z_mean, z_std, normalize, exact):
    n, M, d = z.shape
    return (z.new_empty((n, M), dtype=torch.int32), z.new_empty((n, M, d), dtype=torch.float32),
            z.new_empty((n, M, d), dtype=torch.float32))


def pq_assign(
    z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor, *,
    normalize: str = "none", z_mean: Optional[torch.Tensor] = None,
    z_std: Optional[torch.Tensor] = None, exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused normalise + assign + gather; the op ``equss::pq_assign``.

    z (n, M, d) raw or pre-normalised; c_norm (M, K, d) the normalised
    codebook the distances use; c_raw (M, K, d) the codebook gathered
    from; z_mean/z_std (M, d) for ``z_trainable``.  Returns ``(idx (n, M)
    int32, z_norm (n, M, d) f32, z_q (n, M, d) f32)``.

    CPU tensors: the plain version.  CUDA tensors: the kernel, which
    takes contiguous f32 inside ``kernel_domain_error``'s domain and
    raises on anything else."""
    if normalize not in MODES:
        raise ValueError(f"Unsupported normalize mode {normalize}")
    if normalize == "z_trainable" and (z_mean is None or z_std is None):
        raise ValueError("z_trainable requires z_mean and z_std")
    n, M, d = z.shape
    K = c_norm.shape[1]
    if c_norm.shape != (M, K, d) or c_raw.shape != (M, K, d):
        raise ValueError(f"codebooks must be ({M}, K, {d}), got "
                         f"{tuple(c_norm.shape)} and {tuple(c_raw.shape)}")
    if normalize != "z_trainable":
        z_mean = z_std = None
    return _pq_assign_op(z, c_norm, c_raw, z_mean, z_std, normalize, exact)


pq_assign.launches = 0
