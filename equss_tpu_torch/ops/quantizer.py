"""Product quantization: inference and the param- and EMA-codebook
training paths.

Counterpart of ``equss_tpu/ops/quantizer.py``: ``PQConfig``, ``pq_init``,
``normalize_vectors``, ``pairwise_sqdist``, ``_gather_codewords``,
``_usage_aux``, ``_pallas_assign_ste``, ``ema_codebook_update``,
``pq_forward`` and ``ema_jsd_entropy``.  Parameters and state are plain
dicts of tensors, as in the JAX package, so the two are held against each
other like for like; ``pq_forward`` returns the new state and leaves the
caller's untouched.  Training covers param codebooks (``vq_type="param"``)
and EMA codebooks (``"ema"``: the Laplace-smoothed moving averages of the
assigned vectors, and the softmax of the distances for the JSD and
entropy telemetry); restart, split, dropout, Gumbel and the weighted-sum
output belong to a later slice and raise.

Routing keeps the JAX package's rule: the fused kernel
(``ops/pq_assign.py``) runs whenever the eligibility predicate holds and
``use_pallas`` is ``True``, or ``"auto"`` on a CUDA device (the TPU rule
was keyed on the TPU backend).  On the CPU ``"auto"`` takes the torch
counterpart of the XLA path unless its (n, M, K) distance tensor would
exceed ``pallas_auto_bytes``.  Training takes the kernel only under an
explicit ``use_pallas`` and ``train_route_ok``, through ``AssignSTE``;
EMA training wants the distance softmax and so takes the plain route, as
the JAX package's does.  On CUDA every (d, K) inside the JAX package's
shape rule is inside the kernel's domain (``pq_assign.kernel_domain_error``);
should one ever not be, the predicate raises with the reason instead of
taking the plain route.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from equss_tpu_torch.ops.kmeans import gumbel, kmeans
from equss_tpu_torch.ops.pq_assign import kernel_domain_error, normalize_vectors, pq_assign


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
    use_restart: bool = False
    use_split: bool = False
    need_initialized: str = "none"   # none | kmeans | uni | normal | rand
    pq_dropout: float = 0.0
    decay: float = 0.99              # EMA decay
    eps: float = 1.0e-5              # Laplace smoothing eps
    jsd_ts: float = 1.0              # softmax temperature of distance_prob
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
    uniform(-1/K, 1/K); ``uni`` xavier-uniform; ``normal`` N(0, 2/(K+d));
    ``kmeans`` and ``rand`` the default until ``pq_data_init`` overwrites
    it on the first training batch.  The numbers are drawn on the CPU from
    ``generator``."""
    M, K, d = cfg.num_pq, cfg.num_codebook, cfg.sub_dim
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


def needs_data_init(cfg: PQConfig) -> bool:
    """Whether the quantizer's codebook is initialised from data."""
    return cfg.need_initialized in ("kmeans", "rand")


def pq_data_init(zf: torch.Tensor, params: Dict[str, torch.Tensor],
                 state: Dict[str, torch.Tensor], cfg: PQConfig,
                 generator: Optional[torch.Generator] = None, *,
                 first: Optional[torch.Tensor] = None,
                 gumbel_noise: Optional[torch.Tensor] = None,
                 rand_idx: Optional[torch.Tensor] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The data-dependent codebook init of the first training batch: zf
    (n, M, d) the quantizer's raw input.  ``kmeans``: per subspace, 25
    Lloyd steps from k-means++ seeds (``ops/kmeans.py``; its draws
    ``first`` (M,) and ``gumbel_noise`` (K - 1, M, n)); ``rand``: the rows
    ``rand_idx`` (M, K), each in [0, n).  Either overwrites the codebook (a
    param one) or ``ema_weight`` and ``ema_weight_avg``; the counts stay
    zero.  Other modes return the inputs.  New dicts; the inputs are not
    modified."""
    if not needs_data_init(cfg):
        return params, state
    M, K, d = cfg.num_pq, cfg.num_codebook, cfg.sub_dim
    zm = zf.detach().reshape(-1, M, d).float().transpose(0, 1)        # (M, n, d)
    if cfg.need_initialized == "kmeans":
        weight, _ = kmeans(zm, k=K, n_iters=25, generator=generator, first=first,
                           gumbel_noise=gumbel_noise)
    else:
        if rand_idx is None:
            rand_idx = torch.randint(0, zm.shape[1], (M, K), generator=generator,
                                     device=zm.device)
        weight = torch.gather(zm, 1, rand_idx.to(zm.device).long()[..., None].expand(M, K, d))
    params, state = dict(params), dict(state)
    if cfg.vq_type == "param":
        params["codebook"] = weight.contiguous()
    else:
        state["ema_weight"] = weight.contiguous()
        state["ema_weight_avg"] = weight.clone()
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


def _usage_aux(count: torch.Tensor, K: int) -> Dict[str, torch.Tensor]:
    """Codebook health from (M, K) usage counts: the live-codeword ratio
    and the fraction of codewords covering 10/50/90% of the assignments,
    averaged over subspaces."""
    aux = {"codebook-usage": ((count > 0).float().sum(-1) / K).mean()}
    prob = count / (count.sum(-1, keepdim=True) + 1.0)
    c_sum = prob.sort(-1, descending=True).values.cumsum(-1)
    for q in (10, 50, 90):
        idx_q = (c_sum >= q / 100.0).float().argmax(-1)    # first True, else 0
        aux[f"current-p{q}"] = (idx_q.float() / K).mean()
    return aux


class AssignSTE(torch.autograd.Function):
    """The fused assignment (``pq_assign``: the kernel on CUDA, its plain
    version on the CPU) under the analytic backward of the JAX package's
    ``_pallas_assign_ste`` (quantizer.py:307-358), for training param
    codebooks:

    * d z: the indices are piecewise constant, so z's gradient flows only
      through the z_norm output: the VJP of ``normalize_vectors``
      recomputed at the saved z;
    * d codebook: the transpose of the codeword gather, a scatter-add of
      the z_q cotangent at the indices (``index_add_``; the bf16 codeword
      rounding of the fast mode counts as identity);
    * d codebook_norm: zero, it feeds only the argmin.

    ``apply(z (n, M, d) f32, codebook, codebook_norm, normalize, exact)``
    returns ``(indices, z_norm, z_q)``."""

    @staticmethod
    def forward(ctx, z, codebook, codebook_norm, normalize, exact):
        indices, zn, zq = pq_assign(
            z.contiguous(), codebook_norm.contiguous(), codebook.contiguous(),
            normalize=normalize, exact=exact)
        ctx.save_for_backward(z, indices)
        ctx.normalize = normalize
        ctx.codebook_shape = codebook.shape
        ctx.mark_non_differentiable(indices)
        return indices, zn, zq

    @staticmethod
    def backward(ctx, _d_idx, d_zn, d_zq):
        z, indices = ctx.saved_tensors
        M, K, d = ctx.codebook_shape
        if ctx.normalize == "none":
            d_z = d_zn
        else:
            with torch.enable_grad():
                zs = z.detach().requires_grad_()
                (d_z,) = torch.autograd.grad(
                    normalize_vectors(zs, ctx.normalize), zs, d_zn)
        flat = (indices.long()
                + K * torch.arange(M, device=indices.device)).reshape(-1)
        d_c = torch.zeros((M * K, d), dtype=d_zq.dtype, device=d_zq.device)
        d_c.index_add_(0, flat, d_zq.reshape(-1, d))
        return d_z, d_c.reshape(M, K, d), None, None, None


def ema_codebook_update(state: Dict[str, torch.Tensor], count: torch.Tensor,
                        vec_sum: torch.Tensor, cfg: PQConfig) -> Dict[str, torch.Tensor]:
    """The EMA codebook update with Laplace smoothing: ``count`` (M, K) and
    ``vec_sum`` (M, K, d) of this batch fold into ``ema_count`` and
    ``ema_weight_avg`` at ``decay``, and ``ema_weight`` becomes their
    ratio with the smoothed counts.  Returns a new state dict."""
    decay, eps = cfg.decay, cfg.eps
    ema_count = state["ema_count"] * decay + count * (1.0 - decay)
    ema_weight_avg = state["ema_weight_avg"] * decay + vec_sum * (1.0 - decay)
    n = ema_count.sum(-1, keepdim=True)                               # (M, 1)
    smoothed = (ema_count + eps) / (n + cfg.num_codebook * eps) * n   # (M, K)
    return dict(state, ema_count=ema_count, ema_weight_avg=ema_weight_avg,
                ema_weight=ema_weight_avg / smoothed[..., None])


def split_codes(codebook: torch.Tensor, total_count: torch.Tensor,
                current_count: torch.Tensor, noise: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split of the most used codewords into the dead ones (count 0 in
    this batch): per subspace the j-th dead slot copies the j-th most used
    entry by ``total_count`` plus ``0.02 noise`` (noise (M, K, d) standard
    normal), the source loses the same noise, and both take half of the
    source's count.  Returns (codebook, counts).  The usage order is a
    stable sort, so entries of equal count (the slots dead from the start
    tie at 0) keep their index order, as ``jnp.argsort`` does."""
    M, K, d = codebook.shape
    noise = 0.02 * noise.to(codebook.device, codebook.dtype)
    dead = current_count == 0                                          # (M, K)
    dead_rank = torch.cumsum(dead.long(), -1) - 1
    order = torch.argsort(-total_count, dim=-1, stable=True)           # by descending use
    src = torch.gather(order, -1, dead_rank.clamp(0, K - 1))
    src_weight = torch.gather(codebook, 1, src[..., None].expand(M, K, d))
    src_count = torch.gather(total_count, -1, src)
    new_codebook = torch.where(dead[..., None], src_weight + noise, codebook)
    n_dead = dead.sum(-1, keepdim=True)
    is_src = torch.argsort(order, dim=-1) < n_dead                     # usage rank < dead
    new_count = torch.where(dead, src_count / 2.0, total_count)
    new_count = torch.where(is_src, new_count / 2.0, new_count)
    new_codebook = torch.where(is_src[..., None], new_codebook - noise, new_codebook)
    return new_codebook, new_count


def ema_jsd_entropy(prob_a: torch.Tensor, prob_b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JSD and negative-entropy telemetry between two chunks of distance
    probabilities (..., M, K), averaged over the subspaces: per subspace
    the batch-mean KL JSD and the entropy of the batch-mean probability
    (returned negated, as the reference's entropy loss is)."""
    pa = prob_a.reshape(-1, *prob_a.shape[-2:])
    pb = prob_b.reshape(-1, *prob_b.shape[-2:])

    def kl_batchmean(log_input, p_target):
        log_t = torch.log(p_target + 1e-6)
        return (p_target * (log_t - log_input)).sum(-1).mean(0)

    log_m = torch.log(0.5 * (pa + pb) + 1e-6)
    jsd = (0.5 * (kl_batchmean(log_m, pa) + kl_batchmean(log_m, pb))).mean()
    avg_p = pa.mean(0)                                                # (M, K)
    ent = (-avg_p * torch.log(avg_p + 1e-8)).sum(-1)                  # (M,)
    return jsd, (-ent).mean()


def _train_route_ok(cfg: PQConfig) -> bool:
    """``train_route_ok`` of the JAX package (quantizer.py:527-533): the
    kernel trains only under an explicit ``use_pallas``, a param codebook,
    no restart or split, and a normalisation free of running statistics."""
    return (cfg.use_pallas != "auto"
            and cfg.vq_type == "param"
            and not cfg.use_restart
            and not cfg.use_split
            and cfg.normalize != "z_trainable")


def _check_training_supported(cfg: PQConfig) -> None:
    later = [name for name, on in (
        ("use_restart", cfg.use_restart),
        ("pq_dropout", cfg.pq_dropout > 0.0),
        ("use_weighted_sum", cfg.use_weighted_sum)) if on]
    if later:
        raise NotImplementedError(
            "pq_forward(training=True) is ported for param and EMA codebooks "
            f"without {', '.join(later)}, which belong to a later slice of the port")


def _kernel_eligible(cfg: PQConfig, n: int, device: torch.device,
                     training: bool = False, want_prob: Optional[bool] = None) -> bool:
    """The JAX package's eligibility predicate (quantizer.py:496-543)
    with the TPU backend test read as CUDA; the shape rule is
    ``_kernel_shape_ok``.  A call that wants the distance softmax
    (``_want_prob``: EMA training by default) never takes the kernel, nor
    does ``use_gumbel``, as in JAX."""
    if cfg.use_pallas == "auto":
        if device.type == "cuda":
            want = True
        elif not isinstance(n, int):
            # a symbolic n (torch.export with a symbolic batch) cannot be
            # size-gated: the plain route, as in the JAX package's symbolic
            # trace
            want = False
        else:
            elt = 2 if cfg.assign_precision == "bf16" else 4
            per_chip = n * cfg.num_pq * cfg.num_codebook * elt \
                / max(1, cfg.pallas_auto_shards)
            want = per_chip > cfg.pallas_auto_bytes
    else:
        want = bool(cfg.use_pallas)
    return (want
            and (not training or _train_route_ok(cfg))
            and not _want_prob(cfg, training, want_prob)
            and not cfg.use_weighted_sum
            and not cfg.use_gumbel
            and cfg.pq_dropout == 0.0
            and _kernel_shape_ok(cfg, device))


def _want_prob(cfg: PQConfig, training: bool, want_prob: Optional[bool] = None) -> bool:
    """``want_prob_eff``: the (n, M, K) distance softmax is computed; by
    default in EMA training, else where the caller asks."""
    if want_prob is None:
        return cfg.use_weighted_sum or (training and cfg.vq_type == "ema")
    return want_prob or cfg.use_weighted_sum


def _kernel_shape_ok(cfg: PQConfig, device: torch.device) -> bool:
    """The shape rule of the predicate.  The JAX package's is the TPU
    kernel's layout, ``sub_dim % 8 == 0`` and ``num_codebook % 128 == 0``;
    on the CPU it stands as it is, so that the plain version runs where
    the JAX kernel would.  On CUDA a shape inside it is always the
    kernel's: True, or ``ValueError`` with the reason if the kernel's
    domain (``pq_assign.kernel_domain_error``) ever left one out, never a
    quiet plain route.  Outside it, where JAX takes its XLA path, CUDA
    takes the kernel where its domain holds the shape."""
    jax_rule = cfg.sub_dim % 8 == 0 and cfg.num_codebook % 128 == 0
    if device.type != "cuda":
        return jax_rule
    why = kernel_domain_error(cfg.sub_dim, cfg.num_codebook, cfg.assign_precision != "bf16")
    if why is not None and jax_rule:
        raise ValueError(
            f"the JAX package takes its PQ kernel at d = {cfg.sub_dim}, K = "
            f"{cfg.num_codebook}, but the CUDA kernel cannot: {why}")
    return why is None


def pq_forward(
    z: torch.Tensor,
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    cfg: PQConfig,
    *,
    training: bool = False,
    want_prob: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
    gumbel_noise: Optional[torch.Tensor] = None,
    split_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantize (..., D) features in all M subspaces.

    Returns ``(z_q, indices, aux, new_state)``: z_q (..., D) is the
    straight-through value ``z_norm + (z_q - z_norm).detach()`` in f32,
    indices (..., M) int32, aux holds ``vq-loss`` and ``codebook-sum`` and,
    in training, the usage telemetry of this batch (``codebook-usage``,
    ``current-p10/50/90``).  In training ``new_state["vq_count"]`` adds
    this batch's counts, and an EMA codebook's state (``ema_count``,
    ``ema_weight_avg``, ``ema_weight``) takes this batch's update, then
    with ``use_split`` the split of its most used codewords into the dead
    ones (``split_noise`` (M, K, d) standard normal, drawn from
    ``generator`` unless given).  ``want_prob`` (default: EMA training)
    adds ``aux["distance_prob"]`` (..., M, K), the softmax of the negated
    distances over ``jsd_ts``.  With ``use_gumbel`` in training the
    indices are the argmax of ``gumbel_noise - dist`` (gumbel_noise (n, M,
    K), drawn from ``generator`` unless given) and z_q their raw
    codewords.  z_q comes from the codebook before the update.  The
    caller's ``state`` is not modified."""
    if training:
        _check_training_supported(cfg)
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

    exact = cfg.assign_precision != "bf16"
    want_prob = _want_prob(cfg, training, want_prob)
    gumbel_pick = cfg.use_gumbel and training
    distance_prob = None
    if _kernel_eligible(cfg, n, zf.device, training, want_prob):
        if training:
            indices, z_norm, z_q = AssignSTE.apply(
                zf, codebook, codebook_norm, cfg.normalize, exact)
        else:
            indices, z_norm, z_q = pq_assign(
                zf.contiguous(), codebook_norm.contiguous(), codebook.contiguous(),
                normalize=cfg.normalize, z_mean=z_mean, z_std=z_std, exact=exact)
    else:
        z_norm = normalize_vectors(zf, cfg.normalize, z_mean, z_std)
        # the softmax keeps its autograd graph, as in JAX; the distances
        # of the argmin alone need none
        with contextlib.nullcontext() if want_prob else torch.no_grad():
            dist = pairwise_sqdist(z_norm, codebook_norm, precision=cfg.assign_precision)
            if want_prob:
                distance_prob = torch.softmax(-dist.float() / cfg.jsd_ts, dim=-1)
            if gumbel_pick:
                if gumbel_noise is None:
                    if generator is None:
                        raise ValueError("use_gumbel requires a generator or gumbel_noise")
                    gumbel_noise = gumbel(generator, dist.shape, dist.device)
                indices = (gumbel_noise.to(dist.device) - dist.detach().float()
                           ).argmax(-1).to(torch.int32)
            else:
                indices = dist.detach().argmin(-1).to(torch.int32)
            del dist
        # bf16: the codeword rounds to bf16; its gradient is the f32
        # scatter-add, rounded to bf16 on its way back through the cast,
        # as XLA differentiates the one-hot einsum of bf16 operands.  The
        # Gumbel pick gathers the raw codeword in either precision
        source = (codebook.to(torch.bfloat16).float() if not exact and not gumbel_pick
                  else codebook.float())
        z_q = _gather_codewords(source, indices)

    aux: Dict[str, torch.Tensor] = {}
    new_state = dict(state)
    commitment = torch.mean((z_norm - z_q.detach()) ** 2)
    if cfg.vq_type == "param":
        codebook_loss = torch.mean((z_q - z_norm.detach()) ** 2)
        aux["vq-loss"] = cfg.book * codebook_loss + cfg.beta * commitment
    else:
        aux["vq-loss"] = cfg.beta * commitment
    aux["codebook-sum"] = codebook.abs().sum() / M
    if training:
        with torch.no_grad():
            flat = (indices.long() + K * torch.arange(M, device=indices.device)).reshape(-1)
            # index_add_, not bincount: bincount reads its input's max back
            # to the host, which stalls the step on CUDA
            count = torch.zeros(M * K, device=indices.device).index_add_(
                0, flat, torch.ones(flat.shape, device=indices.device)).reshape(M, K)
            new_state["vq_count"] = state["vq_count"] + count
            aux.update(_usage_aux(count, K))
            if cfg.vq_type == "ema":
                # the sums of the unnormalised z assigned to each codeword,
                # in f32 by index_add_: a scatter, no matrix product, so no
                # TF32 where JAX asks for precision="highest"
                vec_sum = torch.zeros((M * K, d), device=zf.device).index_add_(
                    0, flat, zf.reshape(-1, d))
                new_state = ema_codebook_update(new_state, count,
                                                vec_sum.reshape(M, K, d), cfg)
                if cfg.use_split:
                    if split_noise is None:
                        if generator is None:
                            raise ValueError("use_split requires a generator or split_noise")
                        split_noise = torch.randn((M, K, d), generator=generator,
                                                  device=zf.device)
                    new_state["ema_weight"], new_state["ema_count"] = split_codes(
                        new_state["ema_weight"], new_state["ema_count"], count, split_noise)
    if distance_prob is not None:
        aux["distance_prob"] = distance_prob.reshape(*lead_shape, M, K)
    z_q = z_norm + (z_q - z_norm).detach()          # the straight-through value
    return (z_q.reshape(*lead_shape, M * d), indices.reshape(*lead_shape, M),
            aux, new_state)
