"""Ops of the port.  Each kernel wrapper counts its launches in the
counter ``launch.<name>`` of ``core.trace``; these helpers read and reset
them all."""
from typing import Dict

from equss_tpu_torch.core import trace
from equss_tpu_torch.ops.attention import attention_qkv, fused_attention
from equss_tpu_torch.ops.layernorm import fused_add_layernorm, fused_layernorm
from equss_tpu_torch.ops.pq_assign import pq_assign, pq_assign_shard

KERNEL_WRAPPERS = {
    "attention_qkv": attention_qkv,
    "attention": fused_attention,
    "layernorm": fused_layernorm,
    "add_layernorm": fused_add_layernorm,
    "pq_assign": pq_assign,
    "pq_assign_shard": pq_assign_shard,
}


def launch_counts() -> Dict[str, int]:
    counts = trace.counts()
    return {name: counts.get(f"launch.{name}", 0) for name in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    trace.reset_counts("launch.")
