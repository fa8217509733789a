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
entropy telemetry), with every option of the JAX package: the split and
the restart of dead codewords, codeword dropout, the Gumbel assignment
and the weighted-sum output.  Each option's random draw comes from the
caller's ``torch.Generator``, or is passed in (``keep``, ``cand_idx``,
``gumbel_noise``, ``split_noise``), which is how the tests give the port
JAX's draws.

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

In a global program (``parallel.mesh``) the training counts and the EMA
sums are the global batch's, summed over the ranks as the JAX package's
``_maybe_psum`` sums them over the data axis, and the Gumbel noise is
drawn for the global batch's rows (``parts``: the blocks of the batch
stacked in ``z``), of which each rank takes its own; the restart draws
its candidates among the global batch's rows, gathered on every rank
(JAX's "explicit key + global batch"); the split noise and the dropout
mask are not per row and every rank draws them alike.  ``pallas_auto_shards``
stays 1 there: the size gate sees each rank's own rows already, where
the JAX step sees the global batch and divides by the shards.

On a (data, model) grid (``mesh.make_mesh_2d``) a quantizer whose tensors
``mesh.shard_quantizer`` split on K holds K / model codewords of each
subspace, and ``pq_forward`` sees it by the codebook's width against
``num_codebook``.  Each model rank then finds its first minimum among its
own codewords (the kernel route: ``pq_assign_shard``, the inference
kernel under ``auto`` on CUDA and ``AssignShardSTE`` in training under an
explicit ``use_pallas``; the plain route: ``pairwise_sqdist`` on the
shard, its distances as ``ordered_key``s) and one int64 MIN over the model
group of ``merge_key`` (key << 32 | whole-codebook index) picks the
one-process first minimum: equal keys keep the lower index.  z_q is the
owner's codeword, summed over the model group as its int32 bits (a -0.0
entry stays -0.0) with the identity as backward, so that the codebook's
gradient reaches the owner's rows only.  What runs over the whole K runs
over the model group: ``z_trainable``'s codebook mean and variance (two
all-reduced passes), the EMA smoothing's total count, the usage telemetry
(on the gathered (M, K) counts), ``codebook-sum``, and the distance
softmax (a max and a sum over the model group; ``distance_prob`` is the
shard's (..., M, K / model), and ``ema_jsd_entropy(..., sharded=True)``
sums its terms over the group).  The options that couple codewords
otherwise in training (``use_split``, ``use_restart``, ``pq_dropout``,
``use_gumbel``) gather the (M, K[, d]) tensors over the model group, run
the one-process function and keep this rank's shard of the new state.
The counts are summed over the data group only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from equss_tpu_torch.ops.kmeans import gumbel, kmeans
from equss_tpu_torch.ops.pq_assign import (kernel_domain_error, merge_key, normalize_vectors,
                                           ordered_key, packed_keys, pq_assign, pq_assign_shard)
from equss_tpu_torch.parallel import mesh


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


def _flat_rows(indices: torch.Tensor, M: int, K: int) -> torch.Tensor:
    """indices (n, M) into an (M, K, d) codebook -> (n * M,) int64 rows of
    its flat (M * K, d) view."""
    return (indices.long() + K * torch.arange(M, device=indices.device)).reshape(-1)


def _gather_codewords(codebook: torch.Tensor, indices: torch.Tensor,
                      flat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codebook (M, K, d), indices (n, M) -> (n, M, d): a row gather
    (``index_select``) on the flat (M * K, d) codebook, whose transpose
    autograd takes as one ``index_add_`` scatter; an advanced index's is
    ``index_put_(accumulate=True)``, which sorts the rows and on CUDA sums
    each codeword's duplicates in sequence.  ``flat``: ``_flat_rows`` of
    the indices, where the caller has it already."""
    M, K, d = codebook.shape
    if flat is None:
        flat = _flat_rows(indices, M, K)
    return codebook.reshape(M * K, d).index_select(0, flat).reshape(*indices.shape, d)


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
        return (*_ste_grads(ctx, z, indices, d_zn, d_zq), None, None, None)


def _ste_grads(ctx, z, local_idx, d_zn, d_zq):
    """``AssignSTE``'s gradients of z and of the codebook (whose rows the
    indices ``local_idx`` number)."""
    M, K, d = ctx.codebook_shape
    if ctx.normalize == "none":
        d_z = d_zn
    else:
        with torch.enable_grad():
            zs = z.detach().requires_grad_()
            (d_z,) = torch.autograd.grad(normalize_vectors(zs, ctx.normalize), zs, d_zn)
    flat = _flat_rows(local_idx, M, K)
    d_c = torch.zeros((M * K, d), dtype=d_zq.dtype, device=d_zq.device)
    d_c.index_add_(0, flat, d_zq.reshape(-1, d))
    return d_z, d_c.reshape(M, K, d)


class AssignShardSTE(torch.autograd.Function):
    """``AssignSTE`` on a K shard: ``pq_assign_shard`` forward (codewords
    ``k_offset ..`` of a codebook of ``K_total``), the same backward, the
    codebook's gradient scattered at the shard's own rows.
    ``apply(z, codebook, codebook_norm, normalize, exact, k_offset,
    K_total)`` returns ``(indices, z_norm, z_q, key)``."""

    @staticmethod
    def forward(ctx, z, codebook, codebook_norm, normalize, exact, k_offset, k_total):
        indices, zn, zq, key = pq_assign_shard(
            z.contiguous(), codebook_norm.contiguous(), codebook.contiguous(), k_offset,
            k_total, normalize=normalize, exact=exact)
        ctx.save_for_backward(z, indices)
        ctx.normalize, ctx.k_offset = normalize, k_offset
        ctx.codebook_shape = codebook.shape
        ctx.mark_non_differentiable(indices, key)
        return indices, zn, zq, key

    @staticmethod
    def backward(ctx, _d_idx, d_zn, d_zq, _d_key):
        z, indices = ctx.saved_tensors
        return (*_ste_grads(ctx, z, indices - ctx.k_offset, d_zn, d_zq),
                None, None, None, None, None)


def ema_codebook_update(state: Dict[str, torch.Tensor], count: torch.Tensor,
                        vec_sum: torch.Tensor, cfg: PQConfig,
                        sharded: bool = False) -> Dict[str, torch.Tensor]:
    """The EMA codebook update with Laplace smoothing: ``count`` (M, K) and
    ``vec_sum`` (M, K, d) of this batch fold into ``ema_count`` and
    ``ema_weight_avg`` at ``decay``, and ``ema_weight`` becomes their
    ratio with the smoothed counts.  ``sharded``: the tensors are this
    model rank's K shard, and the smoothing's total count is summed over
    the model group.  Returns a new state dict."""
    decay, eps = cfg.decay, cfg.eps
    ema_count = state["ema_count"] * decay + count * (1.0 - decay)
    ema_weight_avg = state["ema_weight_avg"] * decay + vec_sum * (1.0 - decay)
    n = ema_count.sum(-1, keepdim=True)                               # (M, 1)
    if sharded:
        mesh.model_sum_(n)
    smoothed = (ema_count + eps) / (n + cfg.num_codebook * eps) * n   # (M, K)
    return dict(state, ema_count=ema_count, ema_weight_avg=ema_weight_avg,
                ema_weight=ema_weight_avg / smoothed[..., None])


def restart_dead_codes(codebook: torch.Tensor, count: torch.Tensor, z: torch.Tensor,
                       cand_idx: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       parts: int = 1) -> torch.Tensor:
    """The codewords unused in this batch (``count`` (M, K) == 0) replaced
    by rows of the batch: codeword k of subspace m becomes row
    ``cand_idx[m, k]`` of z (n, M, d) in subspace m, drawn with
    replacement from ``generator`` unless given.  In a global program the
    rows are the global batch's (``parts`` as in ``mesh.gather_rows``),
    so every rank computes the same codebook.  Returns the new (M, K, d)
    codebook."""
    M, K, d = codebook.shape
    rows = mesh.gather_rows(z.detach(), parts)
    if cand_idx is None:
        if generator is None:
            raise ValueError("use_restart requires a generator or cand_idx")
        cand_idx = torch.randint(0, rows.shape[0], (M, K), generator=generator,
                                 device=z.device)
    idx = cand_idx.to(z.device).long()[..., None].expand(M, K, d)
    candidates = torch.gather(rows.transpose(0, 1), 1, idx)            # (M, K, d)
    return torch.where((count == 0)[..., None], candidates.to(codebook.dtype), codebook)


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


def ema_jsd_entropy(prob_a: torch.Tensor, prob_b: torch.Tensor, sharded: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JSD and negative-entropy telemetry between two chunks of distance
    probabilities (..., M, K), averaged over the subspaces: per subspace
    the batch-mean KL JSD and the entropy of the batch-mean probability
    (returned negated, as the reference's entropy loss is).  ``sharded``:
    the probabilities are a model rank's K shard, and the sums over K run
    over the model group (``mesh.model_sum``)."""
    pa = prob_a.reshape(-1, *prob_a.shape[-2:])
    pb = prob_b.reshape(-1, *prob_b.shape[-2:])
    sum_k = (lambda t: mesh.model_sum(t.sum(-1))) if sharded else (lambda t: t.sum(-1))

    def kl_batchmean(log_input, p_target):
        log_t = torch.log(p_target + 1e-6)
        return sum_k(p_target * (log_t - log_input)).mean(0)

    log_m = torch.log(0.5 * (pa + pb) + 1e-6)
    jsd = (0.5 * (kl_batchmean(log_m, pa) + kl_batchmean(log_m, pb))).mean()
    avg_p = pa.mean(0)                                                # (M, K)
    ent = sum_k(-avg_p * torch.log(avg_p + 1e-8))                     # (M,)
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
    keep: Optional[torch.Tensor] = None,
    cand_idx: Optional[torch.Tensor] = None,
    parts: int = 1,
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
    K), drawn from ``generator`` unless given; in a global program this
    rank's rows of the global batch's draw, ``z`` stacking ``parts``
    blocks of the batch) and z_q their raw
    codewords.  z_q comes from the codebook before the update.

    The other options, in training: ``pq_dropout`` p masks each codeword
    (M, K) to an infinite distance with probability p, entry 0 of each
    subspace kept (``keep`` (M, K) bool, drawn as ``uniform > p`` unless
    given); ``use_restart`` replaces the codewords this batch left unused
    by rows of the batch (``restart_dead_codes``, its draw ``cand_idx``):
    an EMA codebook's ``ema_weight`` after the update, its
    ``ema_weight_avg`` set to it and ``ema_count`` to zero where any
    codeword was dead; a param codebook's restart goes to
    ``aux["restarted-codebook"]`` from the normalised rows, for the caller
    to apply.  ``use_weighted_sum`` (inference too; ``normalize: none``)
    makes z_q the distance softmax's mean of the codebook, with no
    straight-through step.  Each of these options takes the plain route,
    as in the JAX package.  The caller's ``state`` is not modified."""
    M, K, d = cfg.num_pq, cfg.num_codebook, cfg.sub_dim
    codebook = params["codebook"] if cfg.vq_type == "param" else state["ema_weight"]
    if codebook.shape[1] != K:
        if training and _couples_codewords(cfg):
            return _pq_forward_gathered(
                z, params, state, cfg, want_prob=want_prob, generator=generator,
                gumbel_noise=gumbel_noise, split_noise=split_noise, keep=keep,
                cand_idx=cand_idx, parts=parts)
        return _pq_forward_shard(z, params, state, cfg, training=training, want_prob=want_prob)
    lead_shape = z.shape[:-1]
    zf = z.reshape(-1, M, d).float()
    n = zf.shape[0]

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
    distance_prob = flat = None
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
            if cfg.pq_dropout > 0.0 and training:
                if keep is None:
                    if generator is None:
                        raise ValueError("pq_dropout requires a generator or keep")
                    keep = torch.rand((M, K), generator=generator,
                                      device=dist.device) > cfg.pq_dropout
                keep = keep.to(dist.device, torch.bool).clone()
                keep[:, 0] = True
                dist = torch.where(keep[None], dist, torch.inf)
            if want_prob:
                distance_prob = torch.softmax(-dist.float() / cfg.jsd_ts, dim=-1)
            if gumbel_pick:
                if gumbel_noise is None:
                    if generator is None:
                        raise ValueError("use_gumbel requires a generator or gumbel_noise")
                    gumbel_noise = mesh.global_rows(
                        lambda rows: gumbel(generator, (rows, *dist.shape[1:]), dist.device),
                        dist.shape[0], parts)
                indices = (gumbel_noise.to(dist.device) - dist.detach().float()
                           ).argmax(-1).to(torch.int32)
            else:
                indices = dist.detach().argmin(-1).to(torch.int32)
            del dist
        # bf16: the codeword rounds to bf16; its gradient is the f32
        # scatter-add, rounded to bf16 on its way back through the cast,
        # as XLA differentiates the one-hot einsum of bf16 operands.  The
        # Gumbel pick gathers the raw codeword in either precision
        if cfg.use_weighted_sum:
            z_q = torch.einsum("nmk,mkd->nmd", distance_prob, codebook_norm.float())
        else:
            source = (codebook.to(torch.bfloat16).float() if not exact and not gumbel_pick
                      else codebook.float())
            flat = _flat_rows(indices, M, K)
            z_q = _gather_codewords(source, indices, flat)

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
            if flat is None:
                flat = _flat_rows(indices, M, K)
            # index_add_, not bincount: bincount reads its input's max back
            # to the host, which stalls the step on CUDA
            count = torch.zeros(M * K, device=indices.device).index_add_(
                0, flat, torch.ones(flat.shape, device=indices.device)).reshape(M, K)
            # the global batch's counts (JAX's ``_maybe_psum``)
            mesh.all_reduce_sum(count)
            new_state["vq_count"] = state["vq_count"] + count
            aux.update(_usage_aux(count, K))
            if cfg.vq_type == "ema":
                # the sums of the unnormalised z assigned to each codeword,
                # in f32 by index_add_: a scatter, no matrix product, so no
                # TF32 where JAX asks for precision="highest"
                vec_sum = mesh.all_reduce_sum(torch.zeros((M * K, d), device=zf.device).index_add_(
                    0, flat, zf.reshape(-1, d)))
                new_state = ema_codebook_update(new_state, count,
                                                vec_sum.reshape(M, K, d), cfg)
                if cfg.use_restart:
                    restarted = restart_dead_codes(new_state["ema_weight"], count, zf,
                                                   cand_idx, generator, parts)
                    any_dead = (count == 0).any()
                    new_state["ema_weight"] = restarted
                    # the reference resets the average to the weight and the
                    # counts to zero on a restart
                    new_state["ema_weight_avg"] = torch.where(
                        any_dead, restarted, new_state["ema_weight_avg"])
                    new_state["ema_count"] = torch.where(
                        any_dead, torch.zeros_like(new_state["ema_count"]),
                        new_state["ema_count"])
                if cfg.use_split:
                    if split_noise is None:
                        if generator is None:
                            raise ValueError("use_split requires a generator or split_noise")
                        split_noise = torch.randn((M, K, d), generator=generator,
                                                  device=zf.device)
                    new_state["ema_weight"], new_state["ema_count"] = split_codes(
                        new_state["ema_weight"], new_state["ema_count"], count, split_noise)
            elif cfg.use_restart:
                # a param codebook is trained: its restart goes to the caller
                aux["restarted-codebook"] = restart_dead_codes(
                    codebook.detach(), count, z_norm, cand_idx, generator, parts)
    if distance_prob is not None:
        aux["distance_prob"] = distance_prob.reshape(*lead_shape, M, K)
    if not cfg.use_weighted_sum:
        z_q = z_norm + (z_q - z_norm).detach()      # the straight-through value
    return (z_q.reshape(*lead_shape, M * d), indices.reshape(*lead_shape, M),
            aux, new_state)


# ----------------------------------------------------- a K-sharded codebook
def _couples_codewords(cfg: PQConfig) -> bool:
    """Training options that couple codewords beyond a sum over K: the
    split, the restart, the dropout mask (entry 0 kept) and the Gumbel
    draw (its K slice)."""
    return cfg.use_split or cfg.use_restart or cfg.pq_dropout > 0.0 or cfg.use_gumbel


def _shard_k(tree: Dict[str, torch.Tensor], gather: bool) -> Dict[str, torch.Tensor]:
    """The quantizer tensors that ``mesh.shard_quantizer`` splits on K,
    gathered whole over the model group (``gather``) or cut to this rank's
    shard; the others as they are."""
    out = {}
    for k, v in tree.items():
        if mesh.QUANTIZER_LEAVES.get(k) == v.ndim:
            v = mesh.gather_k(v) if gather else mesh.take_k(v).contiguous()
        out[k] = v
    return out


def _pq_forward_gathered(z, params, state, cfg, **kw):
    """``pq_forward`` of a K-sharded quantizer under an option that couples
    codewords (``_couples_codewords``): the whole (M, K[, d]) tensors
    gathered over the model group (the codebook's gradient comes back as
    this rank's slice), the one-process function on them, this rank's
    shard of the new state and of a restarted param codebook."""
    z_q, indices, aux, new_state = pq_forward(z, _shard_k(params, True), _shard_k(state, True),
                                              cfg, training=True, **kw)
    if "restarted-codebook" in aux:
        aux["restarted-codebook"] = mesh.take_k(aux["restarted-codebook"]).contiguous()
    return z_q, indices, aux, _shard_k(new_state, False)


def _pq_forward_shard(z, params, state, cfg, *, training, want_prob):
    """``pq_forward`` on this model rank's K shard (the module docstring
    says how); the same outputs as one process, ``distance_prob`` the
    shard's."""
    M, K, d = cfg.num_pq, cfg.num_codebook, cfg.sub_dim
    codebook = params["codebook"] if cfg.vq_type == "param" else state["ema_weight"]
    kp = codebook.shape[1]
    if kp * mesh.model_size() != K:
        raise ValueError(f"a codebook of {kp} codewords is not a shard of {K} over the "
                         f"{mesh.model_size()} model ranks")
    k_off = mesh.model_index() * kp
    lead_shape = z.shape[:-1]
    zf = z.reshape(-1, M, d).float()
    n = zf.shape[0]

    z_mean = z_std = None
    if cfg.normalize == "z_trainable":
        z_mean = params["z_mean"]
        z_std = torch.sqrt(torch.exp(params["z_log_var"]))
        c_mean = mesh.model_sum_sharded(codebook.sum(1, keepdim=True)) / K
        c_var = mesh.model_sum_sharded(((codebook - c_mean) ** 2).sum(1, keepdim=True)
                                       ) / max(K - 1, 1)
        codebook_norm = (codebook - c_mean) / (torch.sqrt(c_var) + 1e-5)
    else:
        codebook_norm = normalize_vectors(codebook, cfg.normalize)

    exact = cfg.assign_precision != "bf16"
    want_prob = _want_prob(cfg, training, want_prob)
    distance_prob = None
    if _kernel_eligible(cfg, n, zf.device, training, want_prob):
        if training:
            idx, z_norm, z_q_own, key = AssignShardSTE.apply(
                zf, codebook, codebook_norm, cfg.normalize, exact, k_off, K)
        else:
            idx, z_norm, z_q_own, key = pq_assign_shard(
                zf.contiguous(), codebook_norm.contiguous(), codebook.contiguous(), k_off, K,
                normalize=cfg.normalize, z_mean=z_mean, z_std=z_std, exact=exact)
        packed = packed_keys(K, exact)
    else:
        z_norm = normalize_vectors(zf, cfg.normalize, z_mean, z_std)
        with contextlib.nullcontext() if want_prob else torch.no_grad():
            dist = pairwise_sqdist(z_norm, codebook_norm, precision=cfg.assign_precision)
            if want_prob:
                # the softmax over the whole K: a max and a sum over the group
                logits = -dist.float() / cfg.jsd_ts
                top = mesh.model_max_(logits.detach().amax(-1, keepdim=True))
                e = torch.exp(logits - top)
                distance_prob = e / mesh.model_sum_sharded(e.sum(-1, keepdim=True))
            # the first minimum among this shard's codewords, by its key
            k = torch.arange(kp, dtype=torch.int64, device=zf.device)
            best = ((ordered_key(dist.detach()) - 2 ** 31) * 2 ** 32 + k).amin(-1)
            key, local = (best >> 32) + 2 ** 31, best & 0xFFFFFFFF
            del dist
        idx = (local + k_off).to(torch.int32)
        packed = False
        if cfg.use_weighted_sum:
            z_q_own = None
        else:
            source = codebook.to(torch.bfloat16).float() if not exact else codebook.float()
            z_q_own = _gather_codewords(source, local)
    # the one-process first minimum over every rank's
    win = mesh.model_min_(merge_key(key, idx, packed))
    indices = (win & 0xFFFFFFFF).to(torch.int32)
    if cfg.use_weighted_sum:
        z_q = mesh.model_sum(torch.einsum("nmk,mkd->nmd", distance_prob, codebook_norm.float()))
    else:
        own = (idx == indices)[..., None]
        z_q = mesh.model_sum(torch.where(own, z_q_own, torch.zeros_like(z_q_own)), exact=True)

    aux: Dict[str, torch.Tensor] = {}
    new_state = dict(state)
    commitment = torch.mean((z_norm - z_q.detach()) ** 2)
    if cfg.vq_type == "param":
        codebook_loss = torch.mean((z_q - z_norm.detach()) ** 2)
        aux["vq-loss"] = cfg.book * codebook_loss + cfg.beta * commitment
    else:
        aux["vq-loss"] = cfg.beta * commitment
    aux["codebook-sum"] = mesh.model_sum(codebook.abs().sum()) / M
    if training:
        with torch.no_grad():
            local = indices.long() - k_off
            mine = ((local >= 0) & (local < kp)).reshape(-1).float()
            flat = _flat_rows(local.clamp(0, kp - 1), M, kp)
            count = torch.zeros(M * kp, device=indices.device).index_add_(
                0, flat, mine).reshape(M, kp)
            mesh.all_reduce_sum(count)          # the data group's rows
            new_state["vq_count"] = state["vq_count"] + count
            aux.update(_usage_aux(mesh.gather_k(count), K))
            if cfg.vq_type == "ema":
                vec_sum = mesh.all_reduce_sum(torch.zeros((M * kp, d), device=zf.device)
                                              .index_add_(0, flat, zf.reshape(-1, d) * mine[:, None]))
                new_state = ema_codebook_update(new_state, count, vec_sum.reshape(M, kp, d),
                                                cfg, sharded=True)
    if distance_prob is not None:
        aux["distance_prob"] = distance_prob.reshape(*lead_shape, M, kp)
    if not cfg.use_weighted_sum:
        z_q = z_norm + (z_q - z_norm).detach()
    return (z_q.reshape(*lead_shape, M * d), indices.reshape(*lead_shape, M),
            aux, new_state)
