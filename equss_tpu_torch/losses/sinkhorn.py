"""SwAV-style cluster loss with Sinkhorn-Knopp targets, single process.

Counterpart of ``equss_tpu/losses/sinkhorn.py``.  The JAX functions take
an ``axis_name`` to sum across devices; a multi-GPU port of that reduce
is ROADMAP.md queue 1, item 7, and until then a non-None ``axis_name``
raises.
"""
from __future__ import annotations

from typing import Optional

import torch


def _single_process(axis_name: Optional[str]) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            "the cross-device Sinkhorn reduce is not ported (ROADMAP.md, queue 1, item 7: "
            "multi-GPU)")


def distributed_sinkhorn(out: torch.Tensor, *, epsilon: float, n_iters: int = 3,
                         axis_name: Optional[str] = None,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sinkhorn normalisation of (n, K) assignment scores -> the (n, K)
    soft assignment.  ``valid`` (n,) bool masks samples out: their column
    of Q is zeroed, they leave the sample count B, and their rows come
    back zero."""
    _single_process(axis_name)
    Q = torch.exp(out / epsilon).T                    # (K, n)
    if valid is None:
        B = Q.shape[1]
    else:
        vf = valid.to(Q.dtype)
        Q = Q * vf[None, :]
        B = vf.sum()
    K = Q.shape[0]
    Q = Q / Q.sum()
    tiny = torch.finfo(Q.dtype).tiny
    for _ in range(n_iters):
        Q = Q / Q.sum(1, keepdim=True).clamp_min(tiny) / K
        Q = Q / Q.sum(0, keepdim=True).clamp_min(tiny) / B
    return (Q * B).T


def cluster_loss(out_prototypes: torch.Tensor, *, temperature: float, epsilon: float,
                 queue_scores: Optional[torch.Tensor] = None,
                 queue_valid: Optional[torch.Tensor] = None,
                 axis_name: Optional[str] = None) -> torch.Tensor:
    """Cross-entropy of the (n, K) prototype scores against their Sinkhorn
    targets; ``queue_scores`` (L, K) are prepended for the Sinkhorn, with
    ``queue_valid`` (L,) marking the live queue slots."""
    n = out_prototypes.shape[0]
    scores = out_prototypes.detach()
    valid = None
    if queue_scores is not None:
        scores = torch.cat([queue_scores.detach(), scores], 0)
        if queue_valid is not None:
            valid = torch.cat([queue_valid.bool(),
                               torch.ones((n,), dtype=torch.bool, device=scores.device)])
    with torch.no_grad():
        q = distributed_sinkhorn(scores, epsilon=epsilon, axis_name=axis_name,
                                 valid=valid)[-n:]
    x = out_prototypes / temperature
    return -0.5 * torch.mean(torch.sum(q * torch.log_softmax(x, dim=1), dim=1))
