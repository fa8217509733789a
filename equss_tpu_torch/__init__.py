"""equss_tpu_torch: EQUSS in PyTorch and CUDA for NVIDIA Hopper (H100),
ported from the JAX package ``equss_tpu``.

Layout mirrors the JAX package (``models/vit.py``, ``ops/quantizer.py``
and so on).  The hand-written kernels live in ``csrc/`` and are built
with nvcc at first use (``ops/_build.py``); each has a plain PyTorch
version beside its wrapper, which runs for tensors on the CPU.  The
package imports torch, numpy and scipy (and PIL where it decodes a
file).

The names below load on first use, so that ``import
equss_tpu_torch.ops`` (the kernels' custom-op registrations, all that a
saved predictor needs) builds no model code.
"""
import importlib

_EXPORTS = {
    "EQUSS": "equss_tpu_torch.models.equss",
    "EQUSSConfig": "equss_tpu_torch.models.equss",
    "PQConfig": "equss_tpu_torch.ops.quantizer",
    "launch_counts": "equss_tpu_torch.ops",
    "reset_launch_counts": "equss_tpu_torch.ops",
    "resolve_device": "equss_tpu_torch.device",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'equss_tpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
