"""The numbers that decide ``correct``, each beside its limit.

Segment cells: for each probe, the mean over the sampled requests'
pixels of how far the reference's score at the predicted class lies
below the reference's best score (0 where the prediction is the
reference's).  Train cells: each checked step's loss, the first gradient
of every leaf as its optimizer took it, and every leaf's change over the
checked steps, each against the reference run from the same weights on
the same batches.  A gap of norms is taken leaf by leaf and measured
against the reference's norm of that leaf or of the median leaf,
whichever is larger.  The gradient's number is the median leaf's gap
(the worst leaf's is one of the probes' small leaves, whose gradients
hang on argmax assignments and read noise); the change has both the
median leaf's and the worst leaf's, so that a leaf or an optimizer left
unmoved shows.  Leaves whose reference gradient is under a thousandth
of the median leaf's (nought to rounding) are left out.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Number = Tuple[str, float, float]        # (name, value, limit)

EXCLUDE_BELOW = 1e-3


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])


def counted_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(g.norm()) for k, g in ref_grads.items()}
    med = _median(list(norms.values()))
    return [k for k, n in norms.items() if n >= EXCLUDE_BELOW * med]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: List[str]) -> Dict[str, float]:
    """| |prog| - |ref| | / max(|ref|, median |ref|) of each of ``leaves``."""
    rn = {k: float(ref[k].norm()) for k in leaves}
    med = _median(list(rn.values()))
    return {k: abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med, 1e-30) for k in leaves}


def median_leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                    leaves: List[str]) -> float:
    return _median(list(leaf_gaps(prog, ref, leaves).values()))


def worst_leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   leaves: List[str]) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def verdict(numbers: List[Number]) -> bool:
    """True where every number is finite and within its limit."""
    return all(v == v and v <= lim for _, v, lim in numbers)
