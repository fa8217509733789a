"""equss_tpu_torch: the EQUSS inference path in PyTorch and CUDA for
NVIDIA Hopper (H100), ported from the JAX package ``equss_tpu``.

Layout mirrors the JAX package (``models/vit.py``, ``ops/quantizer.py``
and so on).  The hand-written kernels live in ``csrc/`` and are built
with nvcc at first use (``ops/_build.py``); each has a plain PyTorch
version beside its wrapper, which runs for tensors on the CPU.  The
package imports torch, numpy and scipy only.
"""
from equss_tpu_torch.device import resolve_device
from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig
from equss_tpu_torch.ops import launch_counts, reset_launch_counts
from equss_tpu_torch.ops.quantizer import PQConfig

__all__ = ["EQUSS", "EQUSSConfig", "PQConfig", "launch_counts",
           "reset_launch_counts", "resolve_device"]
