"""Ops of the port.  Each kernel wrapper counts its own launches in an
integer attribute ``launches``; these helpers read and reset them all."""
from typing import Dict

from equss_tpu_torch.ops.attention import attention_qkv
from equss_tpu_torch.ops.pq_assign import pq_assign

KERNEL_WRAPPERS = {"attention_qkv": attention_qkv, "pq_assign": pq_assign}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
