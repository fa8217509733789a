"""Ops of the port.  Each kernel wrapper counts its own launches in an
integer attribute ``launches``; these helpers read and reset them all."""
from typing import Dict

from equss_tpu_torch.ops.attention import attention_qkv, fused_attention
from equss_tpu_torch.ops.layernorm import fused_add_layernorm, fused_layernorm
from equss_tpu_torch.ops.pq_assign import pq_assign

KERNEL_WRAPPERS = {
    "attention_qkv": attention_qkv,
    "attention": fused_attention,
    "layernorm": fused_layernorm,
    "add_layernorm": fused_add_layernorm,
    "pq_assign": pq_assign,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
