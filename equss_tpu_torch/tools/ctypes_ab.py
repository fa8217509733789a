"""The serving path's two kernels behind plain ctypes wrappers, without
the custom-op dispatcher, for timing the dispatch against them.

``attention_qkv_ctypes`` and ``pq_assign_ctypes`` are the wrappers of
``ops/attention.py`` and ``ops/pq_assign.py`` as they were before the
kernels became ``torch.library`` custom ops: the same checks and the same
launch through ctypes, called straight from Python.  ``ctypes_wrappers()``
puts them in the places the model calls (``models/vit.py`` and
``ops/quantizer.py``) for the duration of a ``with`` block, so one
process can serve the same model both ways in turns (``chip_smoke.py``'s
``custom_op_ab`` phase).  Each counts its launches in ``core.trace``'s
counter ``launch.<name>_ctypes``, beside the custom ops' ``launch.<name>``.
Not used by the package itself.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Optional

import torch

from equss_tpu_torch.core import trace
from equss_tpu_torch.device import check_cuda_tensor, launch_stream, on_device
from equss_tpu_torch.ops import attention
# the package's name ``pq_assign`` is the wrapper function, not the module
pq = importlib.import_module("equss_tpu_torch.ops.pq_assign")


def attention_qkv_ctypes(qkv: torch.Tensor, num_heads: int, scale: float,
                         n_real: Optional[int] = None) -> torch.Tensor:
    B, N, C, hd, n_real = attention._split_heads(qkv, num_heads, n_real)
    if qkv.device.type == "cpu":
        return attention.attention_qkv_reference(qkv, num_heads, scale, n_real)
    check_cuda_tensor(qkv, "qkv", torch.bfloat16)
    if hd != attention.KERNEL_HEAD_DIM:
        raise ValueError(f"attention kernel takes head_dim {attention.KERNEL_HEAD_DIM}, got {hd}")
    attention._check_scale(scale)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    with on_device(qkv):
        err = attention._kernel_lib().attention_qkv_launch(
            qkv.data_ptr(), out.data_ptr(), B, N, num_heads, n_real, scale,
            launch_stream(qkv))
    attention._check_launch("attention_qkv", err)
    trace.count("launch.attention_qkv_ctypes")
    return out


def pq_assign_ctypes(z: torch.Tensor, c_norm: torch.Tensor, c_raw: torch.Tensor, *,
                     normalize: str = "none", z_mean: Optional[torch.Tensor] = None,
                     z_std: Optional[torch.Tensor] = None, exact: bool = True):
    if normalize not in pq.MODES:
        raise ValueError(f"Unsupported normalize mode {normalize}")
    n, M, d = z.shape
    K = c_norm.shape[1]
    if z.device.type == "cpu":
        return pq.pq_assign_reference(z, c_norm, c_raw, normalize=normalize,
                                      z_mean=z_mean, z_std=z_std, exact=exact)
    check_cuda_tensor(z, "z", torch.float32)
    for name, t in (("c_norm", c_norm), ("c_raw", c_raw)):
        check_cuda_tensor(t, name, torch.float32, z.device)
    stats = (None, None)
    if normalize == "z_trainable":
        for name, t in (("z_mean", z_mean), ("z_std", z_std)):
            check_cuda_tensor(t, name, torch.float32, z.device)
        stats = (z_mean.data_ptr(), z_std.data_ptr())
    why = pq.kernel_domain_error(d, K, exact)
    if why:
        raise ValueError(why)
    idx = torch.empty((n, M), dtype=torch.int32, device=z.device)
    zn = torch.empty_like(z)
    zq = torch.empty_like(z)
    ws = pq.kernel_workspace(z, K, exact)
    with on_device(z):
        err = pq._kernel_lib().pq_assign_launch(
            z.data_ptr(), c_norm.data_ptr(), c_raw.data_ptr(), *stats,
            idx.data_ptr(), zn.data_ptr(), zq.data_ptr(), n, M, K, d,
            pq.MODES.index(normalize), int(exact), launch_stream(z),
            None if ws is None else ws.data_ptr())
    if err:
        raise RuntimeError(f"pq_assign launch failed: CUDA error {err}")
    trace.count("launch.pq_assign_ctypes")
    return idx, zn, zq


@contextlib.contextmanager
def ctypes_wrappers():
    """Inside the block the model's attention and PQ calls go through the
    ctypes wrappers above instead of the custom ops."""
    from equss_tpu_torch.models import vit
    from equss_tpu_torch.ops import quantizer

    saved = vit.attention_qkv, quantizer.pq_assign
    vit.attention_qkv, quantizer.pq_assign = attention_qkv_ctypes, pq_assign_ctypes
    try:
        yield
    finally:
        vit.attention_qkv, quantizer.pq_assign = saved
