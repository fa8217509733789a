"""The loss library of the model variants: JSD, entropy, InfoNCE, CLUB,
margin ranking, JSD-positive and the proxy loss.

Counterpart of ``equss_tpu/losses/basic.py``, NHWC with the channel last.
Where the JAX functions draw from a key, these take the draw as an
argument (``idx`` of ``info_nce_loss``, ``rand_q`` of ``jsd_pos_loss``,
``q_idx`` / ``neg_idx`` of ``proxy_loss``), so a caller draws it from its
``torch.Generator`` and a test can feed JAX's own draws.

Three losses are written for the shapes the trainer gives them, where the
JAX form would not fit on a card under eager autograd:

* ``jsd_loss`` runs over blocks of rows in a ``torch.autograd.Function``
  that keeps only its two inputs (views of a softmax that its own
  backward keeps anyway) and forms the gradient block by block:
  ``dJ/dp = (log(p + e) - log m + 1 - (p + q + 2e) / (p + q + e)) / 2B``
  with ``m = (p + q + e) / 2``, and the same for q.  At ``contra``'s
  second quantizer (50 176 rows of 16 x 1024 per half) the unblocked
  form would keep seven 3.3 GB intermediates for the backward.
  ``jsd_loss_reference`` is the unblocked form.

* ``club_loss``'s negative term is O(n d): the mean over j of
  ``sum_d (x_jd - mu_id)^2 ivar_id`` is ``sum_d ivar_id ((xbar_d -
  mu_id)^2 + var_d)`` with the biased variance of x over its rows
  (two passes).  ``club_loss_reference`` keeps JAX's chunked (chunk, n,
  d) form as the plain version for the tests.
* ``margin_ranking_loss`` runs over blocks of rows of the (n, n)
  correlation matrices (``roll`` along a row stays inside the row), in
  a ``torch.autograd.Function`` that keeps only the normalised features
  and forms each block's gradient again in the backward:
  ``dF = G F + G^T F`` block by block.  ``margin_ranking_loss_reference``
  is the unblocked form.
"""
from __future__ import annotations

from typing import Optional

import torch


def _kl_batchmean_logtarget(log_input: torch.Tensor, log_target: torch.Tensor) -> torch.Tensor:
    """``KLDivLoss(reduction='batchmean', log_target=True)``:
    sum(exp(t) (t - i)) / batch size."""
    t = torch.exp(log_target)
    return torch.sum(t * (log_target - log_input)) / log_input.shape[0]


def jsd_loss_reference(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence between probability rows; the 1e-6 sits
    inside the halving of the mixture, as in the reference."""
    log_m = torch.log(0.5 * ((p + q) + 1e-6))
    log_p = torch.log(p + 1e-6)
    log_q = torch.log(q + 1e-6)
    return 0.5 * (_kl_batchmean_logtarget(log_m, log_p)
                  + _kl_batchmean_logtarget(log_m, log_q))


class _JSD(torch.autograd.Function):
    """``jsd_loss_reference`` over blocks of ``block`` rows: the forward
    sums each half's KL terms block by block, the backward forms each
    block's gradient from the saved inputs."""

    @staticmethod
    def forward(ctx, p, q, block):
        rows = p.shape[0]
        kl_p = kl_q = torch.zeros((), dtype=p.dtype, device=p.device)
        for s in range(0, rows, block):
            pb, qb = p[s:s + block], q[s:s + block]
            log_m = torch.log(0.5 * ((pb + qb) + 1e-6))
            log_p, log_q = torch.log(pb + 1e-6), torch.log(qb + 1e-6)
            kl_p = kl_p + torch.sum(torch.exp(log_p) * (log_p - log_m))
            kl_q = kl_q + torch.sum(torch.exp(log_q) * (log_q - log_m))
        ctx.save_for_backward(p, q)
        ctx.block = block
        return 0.5 * (kl_p / rows + kl_q / rows)

    @staticmethod
    def backward(ctx, d_out):
        p, q = ctx.saved_tensors
        rows = p.shape[0]
        d_p, d_q = torch.empty_like(p), torch.empty_like(q)
        scale = 0.5 * d_out / rows
        for s in range(0, rows, ctx.block):
            pb, qb = p[s:s + ctx.block], q[s:s + ctx.block]
            mix = (pb + qb) + 1e-6
            log_m = torch.log(0.5 * mix)
            common = 1.0 - (mix + 1e-6) / mix - log_m
            d_p[s:s + ctx.block] = scale * (torch.log(pb + 1e-6) + common)
            d_q[s:s + ctx.block] = scale * (torch.log(qb + 1e-6) + common)
        return d_p, d_q, None


def jsd_loss(p: torch.Tensor, q: torch.Tensor, *, block: int = 4096) -> torch.Tensor:
    """Jensen-Shannon divergence between probability rows (batch mean
    over the first axis), as ``jsd_loss_reference``, in blocks of
    ``block`` rows that keep no intermediate for the backward."""
    return _JSD.apply(p, q, block)


def entropy_loss(p: torch.Tensor, q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Negative entropy of the batch-mean assignment (only ``p`` is used)."""
    avg_p = p.reshape(-1, p.shape[-1]).mean(0)
    return -torch.sum(-avg_p * torch.log(avg_p + 1e-8), dim=-1)


def _normalize(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "l2":
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    if mode == "z_norm":
        mean = x.mean(1, keepdim=True)
        d = x.shape[1]
        var = ((x - mean) ** 2).sum(1, keepdim=True) / max(d - 1, 1)
        return (x - mean) / (torch.sqrt(var) + 1e-5)
    if mode == "none":
        return x
    raise ValueError(f"Unsupported normalize type {mode}")


def info_nce_draw(generator: torch.Generator, n: int, neg_sample: int,
                  device) -> torch.Tensor:
    """The random negatives of ``info_nce_loss(cal_type='random')``:
    (n, neg_sample) row indices in [0, n)."""
    return torch.randint(0, n, (n, neg_sample), generator=generator, device=device)


def info_nce_loss(
    x1: torch.Tensor,
    x2: torch.Tensor,
    idx: Optional[torch.Tensor] = None,
    *,
    normalize: str = "l2",
    temperature: float = 1.0,
    neg_sample: int = 100,
    cal_type: str = "random",
    reduction: str = "mean",
) -> torch.Tensor:
    """InfoNCE with random, farthest-by-distance or least-cosine negatives
    of x1's own rows.  x1, x2: (b, h, w, d).  ``idx`` (n, neg_sample) are
    the random negatives (``info_nce_draw``); ``distance`` and ``cosine``
    mine them from an (n, n) matrix."""
    d = x1.shape[-1]
    flat_x1 = x1.reshape(-1, d)
    flat_x2 = x2.reshape(-1, d)
    if cal_type == "random":
        if idx is None:
            raise ValueError("info_nce_loss(cal_type='random') takes its draw as idx")
    elif cal_type == "distance":
        sq = (flat_x1 ** 2).sum(-1)
        d2 = sq[:, None] + sq[None] - 2.0 * flat_x1 @ flat_x1.T
        idx = torch.topk(d2, neg_sample, dim=-1).indices
    elif cal_type == "cosine":
        x_norm = _normalize(flat_x1, "l2")
        idx = torch.topk(-(x_norm @ x_norm.T), neg_sample, dim=-1).indices
    else:
        raise ValueError(f"No support {cal_type}")
    neg = flat_x1[idx.long()]                                   # (n, k, d)
    x1n = _normalize(flat_x1, normalize)
    x2n = _normalize(flat_x2, normalize)
    negn = _normalize(neg, normalize)
    positive = torch.exp(x1n * x2n / temperature).sum(1)
    negative = torch.exp(torch.einsum("nd,nkd->nk", x1n, negn) / temperature).sum(1)
    loss = -(torch.log(positive) - torch.log(positive + negative))
    return loss.sum() if reduction == "sum" else loss.mean()


def club_loss(x: torch.Tensor, p_mu: torch.Tensor, p_logvar: torch.Tensor, *,
              chunks: int = 28) -> torch.Tensor:
    """CLUB mutual-information upper bound, O(n d).  x: (b, h, w, d);
    p_mu, p_logvar: (bhw, d).  The mean of positive minus negative over
    the rows JAX's ``chunks`` chunks cover; each row's negative is its
    expectation over all n rows of x, by x's mean and biased variance."""
    d = x.shape[-1]
    flat_x = x.reshape(-1, d)
    n = flat_x.shape[0]
    chunk = max(n // chunks, 1)
    m = (n // chunk) * chunk             # JAX averages over whole chunks only
    inv_var = torch.exp(-p_logvar[:m])
    mu = p_mu[:m]
    positive = -0.5 * (((flat_x[:m] - mu) ** 2) * inv_var).sum(-1)
    mean = flat_x.mean(0)
    var = ((flat_x - mean) ** 2).mean(0)
    negative = -0.5 * (((mean - mu) ** 2 + var) * inv_var).sum(-1)
    return (positive - negative).mean()


def club_loss_reference(x: torch.Tensor, p_mu: torch.Tensor, p_logvar: torch.Tensor, *,
                        chunks: int = 28) -> torch.Tensor:
    """JAX's chunked form, literally: a (chunk, n, d) difference per chunk
    of rows.  The plain version of ``club_loss``, for small n."""
    d = x.shape[-1]
    flat_x = x.reshape(-1, d)
    n = flat_x.shape[0]
    inv_var = torch.exp(-p_logvar)
    positive = -0.5 * (((flat_x - p_mu) ** 2) * inv_var).sum(-1)
    chunk = max(n // chunks, 1)
    n_chunks = n // chunk
    negs = []
    for c in range(n_chunks):
        mu_i = p_mu[c * chunk:(c + 1) * chunk]
        ivar_i = inv_var[c * chunk:(c + 1) * chunk]
        diff = flat_x[None] - mu_i[:, None]
        negs.append(-0.5 * ((diff ** 2) * ivar_i[:, None]).sum(-1).mean(-1))
    negative = torch.stack(negs).reshape(n_chunks, chunk)
    pos_c = positive[:n_chunks * chunk].reshape(n_chunks, chunk)
    return (pos_c - negative).mean(-1).mean()


def _margin_block(ori_n: torch.Tensor, aug_n: torch.Tensor, rows: slice):
    """One block of rows of the margin ranking terms: (elementwise loss,
    s * [loss > 0]) with s = sign(t1 - t2)."""
    r1 = ori_n[rows] @ ori_n.T
    r2 = torch.roll(r1, 1, dims=1)
    t1 = aug_n[rows] @ aug_n.T
    t2 = torch.roll(t1, 1, dims=1)
    target = torch.sign(t1 - t2)
    margin = torch.abs(t1 - t2)
    target_nonzero = torch.where(target == 0, torch.ones_like(target), target)
    elem = -target * (r1 - (r2 + margin / target_nonzero))
    return torch.clamp_min(elem, 0.0), target * (elem > 0)


class _MarginRanking(torch.autograd.Function):
    """mean(max(0, -target (r1 - r2'))) over blocks of ``block`` rows of
    the (n, n) matrices; saves the normalised features only."""

    @staticmethod
    def forward(ctx, ori_n, aug_n, block):
        n = ori_n.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=ori_n.device)
        for r0 in range(0, n, block):
            loss, _ = _margin_block(ori_n, aug_n, slice(r0, min(r0 + block, n)))
            total = total + loss.sum()
        ctx.save_for_backward(ori_n, aug_n)
        ctx.block = block
        return total / (n * n)

    @staticmethod
    def backward(ctx, grad):
        ori_n, aug_n = ctx.saved_tensors
        n = ori_n.shape[0]
        scale = grad / (n * n)
        d_ori = torch.zeros_like(ori_n)
        for r0 in range(0, n, ctx.block):
            rows = slice(r0, min(r0 + ctx.block, n))
            _, sa = _margin_block(ori_n, aug_n, rows)
            # d loss / d r1[i, j] = -sa[i, j] + sa[i, j + 1] (r2 = roll(r1))
            g = (torch.roll(sa, -1, dims=1) - sa) * scale
            d_ori[rows] += g @ ori_n
            d_ori += g.T @ ori_n[rows]
        return d_ori, None, None


def margin_ranking_loss(ori: torch.Tensor, aug: torch.Tensor, *,
                        block: int = 1024) -> torch.Tensor:
    """Margin ranking between the correlation matrices of ori and aug
    (b, h, w, d), margin 0; aug carries no gradient.  Blocks of ``block``
    rows: at most a few (block, n) f32 matrices live at a time."""
    d = ori.shape[-1]
    ori_n = _normalize(ori.reshape(-1, d), "l2")
    aug_n = _normalize(aug.detach().reshape(-1, d), "l2")
    return _MarginRanking.apply(ori_n, aug_n, block)


def margin_ranking_loss_reference(ori: torch.Tensor, aug: torch.Tensor) -> torch.Tensor:
    """The unblocked form (two (n, n) matrices and their by-products):
    the plain version of ``margin_ranking_loss``, for small n."""
    d = ori.shape[-1]
    ori_n = _normalize(ori.reshape(-1, d), "l2")
    aug_n = _normalize(aug.detach().reshape(-1, d), "l2")
    loss, _ = _margin_block(ori_n, aug_n, slice(None))
    return loss.mean()


def jsd_pos_loss(z: torch.Tensor, z_pos: torch.Tensor, z_dis: torch.Tensor,
                 z_pos_dis: torch.Tensor, rand_q: torch.Tensor, *,
                 num_pos: int = 10) -> torch.Tensor:
    """Query / top-k-attention positive JSD.  z, z_pos: (b, h, w, d);
    z_dis, z_pos_dis: (b, h, w, num_pq); ``rand_q`` (b, num_query) the
    query pixels, each in [0, hw)."""
    b, h, w, d = z.shape
    num_pq = z_dis.shape[-1]
    hw = h * w
    zf, zp = z.reshape(b, hw, d), z_pos.reshape(b, hw, d)
    zd, zpd = z_dis.reshape(b, hw, num_pq), z_pos_dis.reshape(b, hw, num_pq)
    rq = rand_q.long()
    num_query = rq.shape[1]
    sample_z = torch.gather(zf, 1, rq[..., None].expand(-1, -1, d))
    sample_zd = torch.gather(zd, 1, rq[..., None].expand(-1, -1, num_pq))
    attn = torch.einsum("bsc,bdc->bsd", sample_z, zp).detach()
    top_idx = torch.topk(attn, num_pos, dim=-1).indices                # (b, q, k)
    zpd_q = zpd[:, None].expand(b, num_query, hw, num_pq)
    zpd_sel = torch.gather(zpd_q, 2, top_idx[..., None].expand(-1, -1, -1, num_pq))
    p = sample_zd[:, :, None, :].expand_as(zpd_sel)
    pf, qf = p.reshape(-1, num_pq), zpd_sel.reshape(-1, num_pq)
    log_m = torch.log(torch.clamp(0.5 * (pf + qf), 1e-7, 1.0))

    def kl(log_input, target):
        return (target * (torch.log(target.clamp_min(1e-30)) - log_input)).sum() \
            / log_input.shape[0]

    return 0.5 * (kl(log_m, pf) + kl(log_m, qf))


def proxy_loss(queue: torch.Tensor, centroids: torch.Tensor, q_idx: torch.Tensor,
               neg_idx: torch.Tensor, *, temperature: float = 1.0) -> torch.Tensor:
    """Proxy InfoNCE over per-cluster memory queues: queries ``q_idx``
    (C, num_queries) from each cluster's queue (C, Q, d) score their
    centroid (C, d) above negatives ``neg_idx`` (C, num_queries *
    num_neg) drawn from the (C - 1) Q entries of the other clusters."""
    n_cluster, q_size, d = queue.shape
    num_queries = q_idx.shape[1]
    num_neg = neg_idx.shape[1] // num_queries
    queries = torch.gather(queue, 1, q_idx.long()[..., None].expand(-1, -1, d))
    flat = queue.reshape(n_cluster * q_size, d)
    own_start = (torch.arange(n_cluster, device=queue.device) * q_size)[:, None]
    neg_idx = neg_idx.long()
    neg_idx = torch.where(neg_idx >= own_start, neg_idx + q_size, neg_idx)
    negs = flat[neg_idx].reshape(n_cluster, num_queries, num_neg, d)
    cands = torch.cat([centroids[:, None, None, :].expand(n_cluster, num_queries, 1, d),
                       negs], dim=2)
    logits = torch.einsum("cqd,cqkd->cqk", _normalize(queries, "l2"),
                          _normalize(cands, "l2")) / temperature
    return -torch.log_softmax(logits, dim=-1)[..., 0].mean()
