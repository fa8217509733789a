"""Product quantization, inference path.

Counterpart of the inference subset of ``equss_tpu/ops/quantizer.py``:
``PQConfig``, ``pq_init``, ``normalize_vectors``, ``pairwise_sqdist``,
``_gather_codewords`` and ``pq_forward(training=False)``.  Parameters and
state are plain dicts of tensors, as in the JAX package, so the two are
held against each other like for like.  The training branches (EMA
updates, restart, split, dropout, Gumbel, usage statistics) and the
weighted-sum output belong to a later slice and raise here.

Routing keeps the JAX package's rule: the fused kernel
(``ops/pq_assign.py``) runs whenever the eligibility predicate holds and
``use_pallas`` is ``True``, or ``"auto"`` on a CUDA device (the TPU rule
was keyed on the TPU backend).  On the CPU ``"auto"`` takes the torch
counterpart of the XLA path unless its (n, M, K) distance tensor would
exceed ``pallas_auto_bytes``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from equss_tpu_torch.ops.pq_assign import normalize_vectors, pq_assign


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Static quantizer configuration (fields and defaults as in
    ``equss_tpu.ops.quantizer.PQConfig``)."""

    num_pq: int = 64                 # M subspaces
    num_codebook: int = 256          # K entries per subspace
    embed_dim: int = 1024            # D = M * d
    vq_type: str = "param"           # "param" | "ema"
    beta: float = 0.25               # commitment loss weight
    book: float = 1.0                # codebook loss weight (param type)
    normalize: str = "l2"            # none | l2 | z_norm | z_trainable
    use_weighted_sum: bool = False
    use_gumbel: bool = False
    need_initialized: str = "none"   # none | uni | normal here
    pq_dropout: float = 0.0
    use_pallas: Any = "auto"         # "auto" | True | False: the fused kernel
    pallas_auto_bytes: float = 1.3e10
    pallas_auto_shards: int = 1
    assign_precision: str = "exact"  # "exact" | "bf16"

    def __post_init__(self):
        if self.embed_dim % self.num_pq != 0:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_pq {self.num_pq}")
        if self.use_weighted_sum and self.normalize != "none":
            raise ValueError("use_weighted_sum requires normalize='none'")
        if self.use_gumbel and self.use_weighted_sum:
            raise ValueError("use_gumbel and use_weighted_sum are exclusive")

    @property
    def sub_dim(self) -> int:
        return self.embed_dim // self.num_pq


def pq_init(generator: torch.Generator, cfg: PQConfig
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, state) with the JAX package's init distributions: default
    uniform(-1/K, 1/K); ``uni`` xavier-uniform; ``normal`` N(0, 2/(K+d)).
    The numbers are drawn on the CPU from ``generator``."""
    M, K, d = cfg.num_pq, cfg.num_codebook, cfg.sub_dim
    if cfg.need_initialized in ("kmeans", "rand"):
        raise NotImplementedError(
            "data-dependent codebook init belongs to the training slice")
    if cfg.need_initialized == "uni":
        bound = math.sqrt(6.0 / (K + d))
        weight = torch.rand((M, K, d), generator=generator) * 2 * bound - bound
    elif cfg.need_initialized == "normal":
        weight = math.sqrt(2.0 / (K + d)) * torch.randn((M, K, d), generator=generator)
    else:
        weight = torch.rand((M, K, d), generator=generator) * (2.0 / K) - 1.0 / K
    params: Dict[str, torch.Tensor] = {}
    state: Dict[str, torch.Tensor] = {"vq_count": torch.zeros((M, K))}
    if cfg.vq_type == "param":
        params["codebook"] = weight
    elif cfg.vq_type == "ema":
        state["ema_weight"] = weight
        state["ema_weight_avg"] = weight.clone()
        state["ema_count"] = torch.zeros((M, K))
    else:
        raise ValueError(f"Unsupported vq_type {cfg.vq_type}")
    if cfg.normalize == "z_trainable":
        params["z_mean"] = torch.zeros((M, d))
        params["z_log_var"] = torch.zeros((M, d))
    return params, state


def pairwise_sqdist(z: torch.Tensor, codebook: torch.Tensor,
                    precision: str = "exact") -> torch.Tensor:
    """z (n, M, d), codebook (M, K, d) -> (n, M, K) squared distances as
    z^2 + c^2 - 2 z.c.  ``exact``: f32 throughout.  ``bf16``: bf16
    operands (squares rounded to bf16), f32 sums, bf16 result."""
    if precision == "bf16":
        zb = z.to(torch.bfloat16)
        cb = codebook.to(torch.bfloat16)
        z_sq = (zb * zb).float().sum(-1)[:, :, None]
        c_sq = (cb * cb).float().sum(-1)[None]
        cross = torch.einsum("nmd,mkd->nmk", zb.float(), cb.float())
        return (z_sq + c_sq - 2.0 * cross).to(torch.bfloat16)
    z = z.float()
    codebook = codebook.float()
    z_sq = (z * z).sum(-1)[:, :, None]
    c_sq = (codebook * codebook).sum(-1)[None]
    cross = torch.einsum("nmd,mkd->nmk", z, codebook)
    return z_sq + c_sq - 2.0 * cross


def _gather_codewords(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """codebook (M, K, d), indices (n, M) -> (n, M, d)."""
    m = torch.arange(codebook.shape[0], device=codebook.device)
    return codebook[m, indices.long()]


def _kernel_eligible(cfg: PQConfig, n: int, device: torch.device) -> bool:
    """The JAX package's eligibility predicate (quantizer.py:496-543),
    inference branch, with the TPU backend test read as CUDA."""
    if cfg.use_pallas == "auto":
        if device.type == "cuda":
            want = True
        else:
            elt = 2 if cfg.assign_precision == "bf16" else 4
            per_chip = n * cfg.num_pq * cfg.num_codebook * elt \
                / max(1, cfg.pallas_auto_shards)
            want = per_chip > cfg.pallas_auto_bytes
    else:
        want = bool(cfg.use_pallas)
    return (want
            and not cfg.use_weighted_sum
            and not cfg.use_gumbel
            and cfg.pq_dropout == 0.0
            and cfg.sub_dim % 8 == 0
            and cfg.num_codebook % 128 == 0)


def pq_forward(
    z: torch.Tensor,
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    cfg: PQConfig,
    *,
    training: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantize (..., D) features in all M subspaces.

    Returns ``(z_q, indices, aux, state)``: z_q (..., D) is
    ``z_norm + (z_q - z_norm)`` in f32, indices (..., M) int32, aux holds
    ``vq-loss`` and ``codebook-sum``.  Inference only."""
    if training:
        raise NotImplementedError(
            "pq_forward(training=True) belongs to the training slice of the port")
    if cfg.use_weighted_sum:
        raise NotImplementedError(
            "the weighted-sum quantizer output is not ported yet")
    M, K, d = cfg.num_pq, cfg.num_codebook, cfg.sub_dim
    lead_shape = z.shape[:-1]
    zf = z.reshape(-1, M, d).float()
    n = zf.shape[0]
    codebook = params["codebook"] if cfg.vq_type == "param" else state["ema_weight"]

    z_mean = z_std = None
    if cfg.normalize == "z_trainable":
        z_mean = params["z_mean"]
        z_std = torch.sqrt(torch.exp(params["z_log_var"]))
        c_mean = codebook.mean(1, keepdim=True)
        c_var = ((codebook - c_mean) ** 2).sum(1, keepdim=True) / max(K - 1, 1)
        codebook_norm = (codebook - c_mean) / (torch.sqrt(c_var) + 1e-5)
    else:
        codebook_norm = normalize_vectors(codebook, cfg.normalize)

    if _kernel_eligible(cfg, n, zf.device):
        indices, z_norm, z_q = pq_assign(
            zf.contiguous(), codebook_norm.contiguous(), codebook.contiguous(),
            normalize=cfg.normalize, z_mean=z_mean, z_std=z_std,
            exact=cfg.assign_precision != "bf16")
    else:
        z_norm = normalize_vectors(zf, cfg.normalize, z_mean, z_std)
        dist = pairwise_sqdist(z_norm, codebook_norm, precision=cfg.assign_precision)
        indices = dist.argmin(-1).to(torch.int32)
        if cfg.assign_precision == "bf16":
            z_q = _gather_codewords(codebook.to(torch.bfloat16), indices).float()
        else:
            z_q = _gather_codewords(codebook.float(), indices)

    commitment = torch.mean((z_norm - z_q) ** 2)
    aux: Dict[str, torch.Tensor] = {}
    if cfg.vq_type == "param":
        aux["vq-loss"] = cfg.book * torch.mean((z_q - z_norm) ** 2) + cfg.beta * commitment
    else:
        aux["vq-loss"] = cfg.beta * commitment
    aux["codebook-sum"] = codebook.abs().sum() / M
    z_q = z_norm + (z_q - z_norm)          # the straight-through value
    return (z_q.reshape(*lead_shape, M * d), indices.reshape(*lead_shape, M),
            aux, dict(state))
