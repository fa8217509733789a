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

``pq_assign_shard`` (the op ``equss::pq_assign_shard``) is the same kernel
on one shard of a codebook split on K over the ranks of a model group
(``parallel/mesh.py``): it computes, for the shard's codewords, what one
launch over the whole codebook computes for them, and returns each row's
winning key beside its index, so that one cross-rank minimum of
``merge_key`` picks the whole launch's first minimum.
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
        lib.pq_assign_shard_launch.restype = ctypes.c_int
        lib.pq_assign_shard_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p] * 2
        lib.pq_assign_workspace_bytes.restype = ctypes.c_size_t
        lib.pq_assign_workspace_bytes.argtypes = [ctypes.c_int] * 4
        lib.pq_assign_shard_workspace_bytes.restype = ctypes.c_size_t
        lib.pq_assign_shard_workspace_bytes.argtypes = [ctypes.c_int] * 5
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


# ------------------------------------------------------- a codebook shard
def packed_keys(K_total: int, exact: bool) -> bool:
    """Whether a launch over a codebook of ``K_total`` takes the packed
    minimum (fast mode, K_total <= 256), whose key is the int32 word
    ``bits(dist) & ~0xFF | k``, rather than ``ordered_key`` of the distance."""
    return not exact and K_total <= 256


def merge_key(key: torch.Tensor, idx: torch.Tensor, packed: bool) -> torch.Tensor:
    """A shard's (key, whole-codebook index) as one int64 whose least value
    over the shards is the whole launch's first minimum: the key's order in
    the high 32 bits (a packed word's signed order, or ``ordered_key``'s
    unsigned order shifted by 2**31), the index in the low 32 bits, so that
    equal keys keep the lower index."""
    high = key if packed else key - 2 ** 31
    return high * 2 ** 32 + idx.to(torch.int64)


def pq_assign_shard_reference(
    z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor, k_offset: int,
    K_total: int, *, normalize: str = "none", z_mean: Optional[torch.Tensor] = None,
    z_std: Optional[torch.Tensor] = None, exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the shard kernel: codebooks (M, K, d) are codewords
    ``k_offset .. k_offset + K - 1`` of a codebook of ``K_total``, and the
    arithmetic is the whole launch's (``pq_assign_reference`` at K_total:
    with ``packed_keys`` the packed word of the whole-codebook index, and
    with l2 the distance ``1 - cross``).  Returns ``(idx (n, M) int32 of
    the whole codebook, z_norm, z_q, key (n, M) int64)``: the first minimum
    among these codewords (NaN never taken, index ``k_offset`` where no
    distance is below +inf), its codeword and its key: the packed word
    with ``packed_keys``, else ``ordered_key`` of its distance (``KEY_INF``
    where none is below +inf)."""
    z = z.float()
    c_norm = c_norm.float()
    M, K = c_norm.shape[:2]
    zn = normalize_vectors(z, normalize, z_mean, z_std)
    z_sq = (zn * zn).sum(-1, keepdim=True)
    c_sq = (c_norm * c_norm).sum(-1)
    k = torch.arange(K, dtype=torch.int64, device=z.device)
    packed = packed_keys(K_total, exact)
    if exact:
        dist = (z_sq + c_sq) - 2.0 * torch.einsum("nmd,mkd->nmk", zn, c_norm)
        zq_src = c_raw.float()
    else:
        cross = torch.einsum("nmd,mkd->nmk", _bf16(zn), _bf16(c_norm))
        dist = 1.0 - cross if normalize == "l2" and packed else (z_sq + c_sq) - 2.0 * cross
        zq_src = _bf16(c_raw.float())
    if packed:
        words = (dist.view(torch.int32) & -256) | (k_offset + k).to(torch.int32)
        key = words.amin(-1).to(torch.int64)
        local = (key & 0xFF) - k_offset
    else:
        best = ((ordered_key(dist) - 2 ** 31) * 2 ** 32 + k).amin(-1)
        key = (best >> 32) + 2 ** 31
        none = key >= KEY_INF
        key = torch.where(none, KEY_INF, key)
        local = torch.where(none, 0, best & 0xFFFFFFFF)
    m = torch.arange(M, device=z.device)
    zq = zq_src[m, local]
    return (local + k_offset).to(torch.int32), zn, zq, key


@torch.library.custom_op("equss::pq_assign_shard", mutates_args=(), device_types="cpu")
def _pq_assign_shard_op(z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor,
                        z_mean: Optional[torch.Tensor], z_std: Optional[torch.Tensor],
                        normalize: str, exact: bool, k_offset: int, k_total: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    idx, zn, zq, key = pq_assign_shard_reference(
        z, c_norm, c_raw, k_offset, k_total, normalize=normalize, z_mean=z_mean, z_std=z_std,
        exact=exact)
    return idx, (zn.clone() if normalize == "none" else zn), zq, key


@_pq_assign_shard_op.register_kernel("cuda")
def _pq_assign_shard_cuda(z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor,
                          z_mean: Optional[torch.Tensor], z_std: Optional[torch.Tensor],
                          normalize: str, exact: bool, k_offset: int, k_total: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
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
    why = kernel_domain_error(d, k_total, exact)
    if why:
        raise ValueError(why)
    idx = torch.empty((n, M), dtype=torch.int32, device=z.device)
    zn = torch.empty_like(z)
    zq = torch.empty_like(z)
    key = torch.empty((n, M), dtype=torch.int64, device=z.device)
    lib = _kernel_lib()
    nbytes = lib.pq_assign_shard_workspace_bytes(M, K, k_total, d, int(exact))
    ws = torch.empty(nbytes, dtype=torch.uint8, device=z.device) if nbytes else None
    with on_device(z):
        err = lib.pq_assign_shard_launch(
            z.data_ptr(), c_norm.data_ptr(), c_raw.data_ptr(), *stats,
            idx.data_ptr(), zn.data_ptr(), zq.data_ptr(), key.data_ptr(), n, M, K, d,
            k_offset, k_total, MODES.index(normalize), int(exact), launch_stream(z),
            None if ws is None else ws.data_ptr())
    if err:
        raise RuntimeError(f"pq_assign_shard launch failed: CUDA error {err}")
    pq_assign_shard.launches += 1
    return idx, zn, zq, key


@_pq_assign_shard_op.register_fake
def _pq_assign_shard_fake(z, c_norm, c_raw, z_mean, z_std, normalize, exact, k_offset,
                          k_total):
    n, M, d = z.shape
    return (z.new_empty((n, M), dtype=torch.int32), z.new_empty((n, M, d), dtype=torch.float32),
            z.new_empty((n, M, d), dtype=torch.float32),
            z.new_empty((n, M), dtype=torch.int64))


def pq_assign_shard(
    z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor, k_offset: int,
    K_total: int, *, normalize: str = "none", z_mean: Optional[torch.Tensor] = None,
    z_std: Optional[torch.Tensor] = None, exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``pq_assign`` on codewords ``k_offset .. k_offset + K - 1`` (c_norm,
    c_raw (M, K, d)) of a codebook of ``K_total``; the op
    ``equss::pq_assign_shard``.  Returns ``(idx, z_norm, z_q, key)`` as
    ``pq_assign_shard_reference`` states them.  CPU tensors: the plain
    version.  CUDA tensors: the kernel, which raises on what it does not
    take."""
    if normalize not in MODES:
        raise ValueError(f"Unsupported normalize mode {normalize}")
    if normalize == "z_trainable" and (z_mean is None or z_std is None):
        raise ValueError("z_trainable requires z_mean and z_std")
    n, M, d = z.shape
    K = c_norm.shape[1]
    if c_norm.shape != (M, K, d) or c_raw.shape != (M, K, d):
        raise ValueError(f"codebooks must be ({M}, K, {d}), got "
                         f"{tuple(c_norm.shape)} and {tuple(c_raw.shape)}")
    if not 0 <= k_offset <= K_total - K:
        raise ValueError(f"codewords {k_offset}..{k_offset + K - 1} are not inside a "
                         f"codebook of {K_total}")
    if normalize != "z_trainable":
        z_mean = z_std = None
    return _pq_assign_shard_op(z, c_norm, c_raw, z_mean, z_std, normalize, exact,
                               int(k_offset), int(K_total))


pq_assign_shard.launches = 0
