"""SwAV-style cluster loss with Sinkhorn-Knopp targets.

Counterpart of ``equss_tpu/losses/sinkhorn.py``.  In a global program
(``parallel.mesh``) the sample count ``B``, the total ``sum_Q`` and the
row sums are summed over the ranks, as the JAX functions' ``psum`` over
``axis_name`` sums them over the data axis; each rank's scores are its
own rows.  A queue that ``cluster_loss`` prepends is the same on every
rank, and is counted once: as rank 0's samples.  ``axis_name`` names
the axis, as the JAX functions' ``psum(., axis_name)`` does: ``None`` or
``"data"`` the program's ranks (on a (data, model) grid its data group),
``"model"`` the grid's model group (``mesh.make_mesh_2d``), whose ranks
then hold the samples.
"""
from __future__ import annotations

from typing import Optional

import torch

from equss_tpu_torch.parallel import mesh


def _axis(axis_name: Optional[str]):
    """(sum in place, ranks, this rank's index) of the named axis."""
    if axis_name in (None, "data"):
        return mesh.all_reduce_sum, mesh.program_world(), mesh.program_rank()
    if axis_name == "model":
        if mesh.model_size() == 1:
            return (lambda t: t), 1, 0
        return mesh.model_sum_, mesh.model_size(), mesh.model_index()
    raise ValueError(f"axis_name must be None, 'data' or 'model', got {axis_name!r}")


def distributed_sinkhorn(out: torch.Tensor, *, epsilon: float, n_iters: int = 3,
                         axis_name: Optional[str] = None,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sinkhorn normalisation of (n, K) assignment scores -> the (n, K)
    soft assignment.  ``valid`` (n,) bool masks samples out: their column
    of Q is zeroed, they leave the sample count B, and their rows come
    back zero.  In a global program ``out`` holds this rank's samples
    and the sums run over every rank's."""
    axis_sum, ranks, _ = _axis(axis_name)
    Q = torch.exp(out / epsilon).T                    # (K, n)
    if valid is None:
        B = Q.shape[1] * ranks
    else:
        vf = valid.to(Q.dtype)
        Q = Q * vf[None, :]
        B = axis_sum(vf.sum())
    K = Q.shape[0]
    Q = Q / axis_sum(Q.sum())
    tiny = torch.finfo(Q.dtype).tiny
    for _ in range(n_iters):
        Q = Q / axis_sum(Q.sum(1, keepdim=True)).clamp_min(tiny) / K
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
    sums on the first rank of the axis only."""
    n = out_prototypes.shape[0]
    scores = out_prototypes.detach()
    valid = None
    if queue_scores is not None:
        _, ranks, index = _axis(axis_name)
        if ranks > 1:
            # every rank holds the queue: it counts as the first rank's samples
            live = (torch.ones(queue_scores.shape[:1], dtype=torch.bool, device=scores.device)
                    if queue_valid is None else queue_valid.bool())
            queue_valid = live & (index == 0)
        scores = torch.cat([queue_scores.detach(), scores], 0)
        if queue_valid is not None:
            valid = torch.cat([queue_valid.bool(),
                               torch.ones((n,), dtype=torch.bool, device=scores.device)])
    with torch.no_grad():
        q = distributed_sinkhorn(scores, epsilon=epsilon, axis_name=axis_name,
                                 valid=valid)[-n:]
    x = out_prototypes / temperature
    return -0.5 * torch.mean(torch.sum(q * torch.log_softmax(x, dim=1), dim=1))
