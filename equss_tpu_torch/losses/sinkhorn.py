"""SwAV-style cluster loss with Sinkhorn-Knopp targets.

Counterpart of ``equss_tpu/losses/sinkhorn.py``.  In a global program
(``parallel.mesh``) the sample count ``B``, the total ``sum_Q`` and the
row sums are summed over the ranks, as the JAX functions' ``psum`` over
``axis_name`` sums them over the data axis; each rank's scores are its
own rows.  A queue that ``cluster_loss`` prepends is the same on every
rank, and is counted once: as rank 0's samples.  ``axis_name`` names
that axis: ``None`` or ``"data"``, the only one the port has; a model
axis is ROADMAP.md queue 1, item 9.
"""
from __future__ import annotations

from typing import Optional

import torch

from equss_tpu_torch.parallel import mesh


def _data_axis(axis_name: Optional[str]) -> None:
    if axis_name not in (None, "data"):
        raise NotImplementedError(
            f"axis_name {axis_name!r}: the port reduces over the ranks of its data axis "
            f"only; other axes are {mesh.TENSOR_PARALLEL_ITEM}")


def distributed_sinkhorn(out: torch.Tensor, *, epsilon: float, n_iters: int = 3,
                         axis_name: Optional[str] = None,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sinkhorn normalisation of (n, K) assignment scores -> the (n, K)
    soft assignment.  ``valid`` (n,) bool masks samples out: their column
    of Q is zeroed, they leave the sample count B, and their rows come
    back zero.  In a global program ``out`` holds this rank's samples
    and the sums run over every rank's."""
    _data_axis(axis_name)
    Q = torch.exp(out / epsilon).T                    # (K, n)
    if valid is None:
        B = Q.shape[1] * mesh.program_world()
    else:
        vf = valid.to(Q.dtype)
        Q = Q * vf[None, :]
        B = mesh.all_reduce_sum(vf.sum())
    K = Q.shape[0]
    Q = Q / mesh.all_reduce_sum(Q.sum())
    tiny = torch.finfo(Q.dtype).tiny
    for _ in range(n_iters):
        Q = Q / mesh.all_reduce_sum(Q.sum(1, keepdim=True)).clamp_min(tiny) / K
        Q = Q / Q.sum(0, keepdim=True).clamp_min(tiny) / B
    return (Q * B).T


def cluster_loss(out_prototypes: torch.Tensor, *, temperature: float, epsilon: float,
                 queue_scores: Optional[torch.Tensor] = None,
                 queue_valid: Optional[torch.Tensor] = None,
                 axis_name: Optional[str] = None) -> torch.Tensor:
    """Cross-entropy of the (n, K) prototype scores against their Sinkhorn
    targets; ``queue_scores`` (L, K) are prepended for the Sinkhorn, with
    ``queue_valid`` (L,) marking the live queue slots.  In a global
    program the queue, which every rank holds alike, joins the Sinkhorn's
    sums on rank 0 only."""
    n = out_prototypes.shape[0]
    scores = out_prototypes.detach()
    valid = None
    if queue_scores is not None:
        if mesh.in_program():
            # every rank holds the queue: it counts as rank 0's samples
            live = (torch.ones(queue_scores.shape[:1], dtype=torch.bool, device=scores.device)
                    if queue_valid is None else queue_valid.bool())
            queue_valid = live & (mesh.program_rank() == 0)
        scores = torch.cat([queue_scores.detach(), scores], 0)
        if queue_valid is not None:
            valid = torch.cat([queue_valid.bool(),
                               torch.ones((n,), dtype=torch.bool, device=scores.device)])
    with torch.no_grad():
        q = distributed_sinkhorn(scores, epsilon=epsilon, axis_name=axis_name,
                                 valid=valid)[-n:]
    x = out_prototypes / temperature
    return -0.5 * torch.mean(torch.sum(q * torch.log_softmax(x, dim=1), dim=1))
