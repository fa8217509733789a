"""Model variants of the EQUSS skeleton.

Counterpart of ``equss_tpu/models/variants.py``: its shared parts
(``codebook_usage_percentiles``, the backbone plumbing, ``_EncStack`` and
``_DecStack``) and its ten families:

* ``ClusterModel`` ('cluster'): an encoder and the margin ranking between
  the correlation matrices of the image and its photometric view, with
  the SwAV path (L2-normalised prototypes, Sinkhorn targets over a
  bounded queue, prototypes frozen for their first steps) where
  ``loss.swav_weight`` is set;
* ``ResModel`` ('res'): semantic and local encoders, a BatchNorm decoder
  back to the features, InfoNCE between the views' semantic halves and
  the CLUB bound between their local halves, the CLUB encoder trained by
  its own inner loop of Adam steps;
* ``PQGOCLSModel`` ('pqgocls'): a student head and its EMA teacher; the
  quantizer's indices of the teacher are the pseudo-labels of a grouped
  per-subspace classifier on the student, with an MSE to the teacher and
  the STEGO loss;
* ``UnSegModel`` ('hihi'): a linear-flavour encoder, a chain of
  quantizers (each fed by a biasless projection after LeakyReLU, the next
  link projecting ``concat(f, z_q)``), their outputs aggregated and
  decoded back to the features through BatchNorm blocks;
* ``NewVQModel`` ('new'): a module-flavour encoder, one quantizer, the
  BatchNorm decoder back to the features and InfoNCE between the views'
  codes; ``model.stage: 1`` trains on the ``n_kmeans`` pixels nearest
  each k-means centroid of the batch's features (``ops/kmeans.py``);
* ``SPQModel`` ('spq'): one Dense encoder and soft product quantization
  (a softmax over the negated squared distances weighs the codewords),
  JSD between the views' assignments and InfoNCE;
* ``ContraModel`` ('contra'): UnSeg's chain over the image and its view,
  the JSD of the first and the last quantizer's distance softmax between
  the halves;
* ``VAEModel`` ('vae'): a top quantizer on a strided encoding, a bottom
  one conditioned on the decoded top, and the same JSD contrast;
* ``InfoModel`` ('info'): a chain of BatchNorm'd projections into
  Gumbel-assigned quantizers beside a running feature, all decoded back;
* ``EMAModel`` ('ema'): a student head and its momentum teacher, a
  per-cluster memory bank initialised by k-means and the proxy InfoNCE
  against trainable centroids.

Each is an ``nn.Module`` whose ``forward(img, img_pos, *, aug_img,
training, generator, ...)`` returns ``feat``, ``code`` and ``aux`` (and
``z_q`` / ``indices`` where it quantizes), as the JAX ``apply`` does.
What JAX keeps in ``model_state`` lives in buffers: the SwAV queue and
counters, the EMA head, the CLUB encoder and its Adam moments, the
quantizers' counts and the BatchNorm running averages.  A training
forward never writes them: it returns their new values under ``state``
(buffer name -> tensor), and the trainer copies them in only after a
finite step.  The CLUB encoder and the EMA head are buffers, not
parameters, so no optimizer of the model picks them up.  Random draws
come from the caller's ``generator``; ``info_nce_idx``,
``stego_override``, NewVQ's ``kmeans_first`` / ``kmeans_gumbel``, the
quantizers' ``gumbel_<i>`` / ``split_noise_<i>``, EMAModel's
``dropout_keep`` and ``proxy_q_idx`` / ``proxy_neg_idx`` replace them;
``draw_keys`` names those a model's forward reads besides the view's.
A model whose state starts from data (``needs_data_init``: a ``kmeans``
or ``rand`` codebook, EMAModel's bank) has ``data_init(img, generator,
**draws)``, which returns the new tensors by name (the k-means and
``rand`` draws ``kmeans_first_<i>`` / ``kmeans_gumbel_<i>`` /
``rand_idx_<i>`` where given), for ``Trainer.data_init`` to copy in.

In a global program (``parallel.mesh``) every family runs data-parallel
as one process runs the global batch: the losses couple rows through
``losses/basic.py`` (InfoNCE, the margin, CLUB), the Sinkhorn and
BatchNorm, which reduce or gather over the ranks, and the quantizers'
counts and Gumbel noise; besides, ``ClusterModel`` fills the SwAV queue
from the gathered codes, ``ResModel``'s CLUB encoder takes the mean of
the ranks' inner gradients, ``EMAModel`` ranks the gathered student rows
into its bank, and NewVQ's stage 1 runs its k-means and selection on
the gathered rows alike on every rank and its quantizer and decoder on
each rank's equal share of the selected rows.  ``data_init`` needs
nothing of its own: the trainer hands it the gathered images.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from equss_tpu_torch.device import DeviceLike, resolve_device
from equss_tpu_torch.losses.basic import (club_loss, info_nce_draw, info_nce_loss, jsd_loss,
                                          margin_ranking_loss, proxy_loss)
from equss_tpu_torch.losses.sinkhorn import cluster_loss
from equss_tpu_torch.losses.stego import stego_loss
from equss_tpu_torch.models.equss import (_Buffers, backbone_settings, pq_config_from_dict,
                                          pq_data_init_named, stego_config_from_dict)
from equss_tpu_torch.models.heads import (BatchNorm, BNUpdates, CLUBEncoder, Conv2d,
                                          ConvTranspose2dTorch, DecResBlock, EncResBlock,
                                          ExpansionHead, LinDecResBlock, LinEncResBlock,
                                          ReLUResBlock, SegmentationHead, as_state, dropout2d)
from equss_tpu_torch.models.vit import Dense, VisionTransformer, make_vit_config
from equss_tpu_torch.ops.kmeans import kmeans
from equss_tpu_torch.ops.quantizer import PQConfig, needs_data_init, pq_forward, pq_init
from equss_tpu_torch.parallel import mesh


def codebook_usage_percentiles(count: torch.Tensor, prefix: str = "") -> Dict[str, torch.Tensor]:
    """p10 / p50 / p90 of the sorted usage CDF: the fraction of codewords
    that cover 10, 50 and 90% of the counts."""
    count = count.reshape(-1).float()
    k = count.shape[0]
    prob = torch.sort(count / (count.sum() + 1.0), descending=True).values
    c_sum = torch.cumsum(prob, 0)
    return {f"{prefix}-p{q}": (c_sum >= q / 100.0).float().argmax() / k for q in (10, 50, 90)}


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class _EncStack(nn.Module):
    """``num_blocks`` encoder blocks ``enc_{i}``, c_in -> out: the
    ``module`` flavour (``EncResBlock``) or the ``linear`` one
    (``LinEncResBlock``)."""

    def __init__(self, c_in: int, out: int, num_blocks: int, flavor: str,
                 generator: torch.Generator):
        super().__init__()
        blk = LinEncResBlock if flavor == "linear" else EncResBlock
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            setattr(self, f"enc_{i}", blk(c_in if i == 0 else out, out, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"enc_{i}")(x)
        return x


class _DecStack(nn.Module):
    """``num_blocks`` BatchNorm decoder blocks ``dec_{i}`` of width
    ``hidden_dim``, the last to ``out_dim``, and a LayerNorm ``dec_norm``
    with ``last_norm``; flavour as in ``_EncStack``."""

    def __init__(self, c_in: int, hidden_dim: int, out_dim: int, num_blocks: int,
                 last_norm: bool, flavor: str, generator: torch.Generator):
        super().__init__()
        blk = LinDecResBlock if flavor == "linear" else DecResBlock
        self.num_blocks = num_blocks
        width = c_in
        for i in range(num_blocks):
            out = out_dim if i == num_blocks - 1 else hidden_dim
            setattr(self, f"dec_{i}", blk(width, out, generator))
            width = out
        self.dec_norm = nn.LayerNorm(width, eps=1e-6) if last_norm else None

    def forward(self, x: torch.Tensor, train: bool = True,
                updates: Optional[BNUpdates] = None) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"dec_{i}")(x, train, updates)
        return x if self.dec_norm is None else self.dec_norm(x)


class _Variant(nn.Module):
    """The frozen backbone every variant shares (``_BackboneMixin``):
    ``model.pretrained`` as ``backbone_settings`` reads it (the bf16
    backbone with bf16 attention under ``precision: bf16``), channel
    dropout settings, and ``features``."""

    consumes_aug = False
    draw_keys: Tuple[str, ...] = ()

    def _setup(self, cfg: Dict[str, Any], device: DeviceLike, seed: int) -> torch.Generator:
        super().__init__()
        self.device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        pre = cfg["model"]["pretrained"]
        s = backbone_settings(pre)
        self.vit_cfg = make_vit_config(s["model_type"], s["patch_size"],
                                       dtype=s["backbone_dtype"], attn_bf16=s["attn_bf16"],
                                       gelu=s["gelu"], ln_stats=s["ln_stats"])
        self.backbone = VisionTransformer(self.vit_cfg, device=self.device,
                                          generator=generator)
        self.backbone.requires_grad_(False)          # frozen
        self.feat_dim = self.vit_cfg.embed_dim
        self.patch_size = s["patch_size"]
        self.dropout = pre.get("dropout", False)
        self.drop_prob = pre.get("drop_prob", 0.1)
        return generator

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """Frozen backbone dense features (b, gh, gw, C) in f32."""
        with torch.no_grad():
            return self.backbone(img)["dense"].float()

    def _bn_state(self, updates: BNUpdates) -> Dict[str, torch.Tensor]:
        """BatchNorm updates (module -> (mean, var)) -> buffer names."""
        out = {}
        for name, mod in self.named_modules():
            if mod in updates:
                out[f"{name}.mean"], out[f"{name}.var"] = updates[mod]
        return out


def _info_nce(x1: torch.Tensor, x2: torch.Tensor, kwargs: Dict[str, Any],
              idx: Optional[torch.Tensor], generator: Optional[torch.Generator]) -> torch.Tensor:
    """InfoNCE between two halves, the random negatives ``idx`` drawn from
    ``generator`` unless given."""
    if kwargs["cal_type"] == "random" and idx is None:
        if generator is None:
            raise ValueError("random InfoNCE negatives need a generator or info_nce_idx")
        n = x1.reshape(-1, x1.shape[-1]).shape[0]
        idx = info_nce_draw(generator, n, kwargs["neg_sample"], x1.device)
    return info_nce_loss(x1, x2, idx, **kwargs)


def _info_nce_kwargs(loss_cfg: Dict[str, Any], neg_sample: int) -> Dict[str, Any]:
    ince = loss_cfg.get("info_nce", {}) or {}
    return dict(normalize=ince.get("normalize", "l2"),
                neg_sample=ince.get("neg_sample", neg_sample),
                temperature=ince.get("temperature", 1.0),
                cal_type=ince.get("cal_type", "random"))


def _pq_draws(draws: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Quantizer ``i``'s Gumbel and split noise where ``draws`` (a
    forward's keyword arguments) fix them: ``gumbel_<i>``,
    ``split_noise_<i>``."""
    return {"gumbel_noise": draws.get(f"gumbel_{i}"),
            "split_noise": draws.get(f"split_noise_{i}")}


def _pq_draw_keys(num: int) -> Tuple[str, ...]:
    """The draw keys of a chain of ``num`` quantizers (``_pq_draws``)."""
    return tuple(f"{k}_{i}" for i in range(num) for k in ("gumbel", "split_noise"))


def _pq_configs(vq: Dict[str, Any], num: int, num_pq, **extra) -> list:
    """One ``PQConfig`` per level from ``model.vq`` (``num_pq[i]``,
    ``num_codebooks[i]``, ``embed_dims[i]``), with the fields the JAX
    multi-level families read."""
    return [PQConfig(
        num_pq=num_pq[i], num_codebook=vq["num_codebooks"][i], embed_dim=vq["embed_dims"][i],
        vq_type=vq.get("vq_type", "param"),
        assign_precision=vq.get("assign_precision", "exact"),
        need_initialized=vq.get("need_initialized", "none"), beta=vq.get("beta", 0.25),
        normalize=vq.get("normalize", "none"), use_restart=vq.get("use_restart", False),
        use_gumbel=vq.get("use_gumbel", False), decay=vq.get("decay", 0.99),
        eps=vq.get("eps", 1e-5), **extra) for i in range(num)]


def _halves_jsd(prob: torch.Tensor, cfg: PQConfig) -> torch.Tensor:
    """The JSD between the (image, view) halves of a quantizer's distance
    softmax, over pixel rows of the concatenated books (M K), as the
    reference's wrapper hands them to its JSD."""
    flat = prob.reshape(-1, cfg.num_pq * cfg.num_codebook)
    half = flat.shape[0] // 2
    return jsd_loss(flat[:half], flat[half:])


# ---------------------------------------------------------------- cluster

class ClusterModel(_Variant):
    """Encoder + margin ranking between the (image, view) correlation
    matrices, and the SwAV path where ``loss.swav_weight`` > 0: the
    (2 b h w, d) L2-normalised codes score L2-normalised prototypes
    (frozen while ``swav_it`` < ``freeze_prototypes_niter``: a select on
    the device counter, no host read), Sinkhorn targets take the live
    queue slots once ``swav_it`` >= ``queue_start_iter``, and a strided
    subsample of the codes enters the queue first-in first-out."""

    consumes_aug = True

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0):
        generator = self._setup(cfg, device, seed)
        m = cfg["model"]
        self.hidden_dim = m.get("semantic_dim", m.get("hidden_dim", self.feat_dim))
        self.net = _EncStack(self.feat_dim, self.hidden_dim, m.get("enc_num_blocks", 1),
                             "module", generator)
        lc = cfg.get("loss", {}) or {}
        self.swav = float(lc.get("swav_weight", 0.0) or 0.0) > 0.0
        cl = lc.get("cluster", {}) or {}
        self.num_prototypes = int(cl.get("num_prototypes", 1024))
        self.swav_temp = float(cl.get("temperature", 0.1))
        self.swav_eps = float(cl.get("eps", 0.03))
        self.queue_start_iter = int(cl.get("queue_start_iter", 150))
        self.queue_stack_iter = int(cl.get("queue_stack_iter", 5))
        self.freeze_protos_niter = int(cl.get("freeze_prototypes_niter", 100))
        self.queue_len = int(cl.get("queue_len", 4096))
        self.use_infonce = float(lc.get("info_nce_weight", 0.0) or 0.0) > 0.0
        self.info_nce_kwargs = _info_nce_kwargs(lc, 100)
        if self.swav:
            self.prototypes = nn.Parameter(
                torch.randn((self.num_prototypes, self.hidden_dim), generator=generator)
                / math.sqrt(self.hidden_dim))
            self.register_buffer("swav_queue", torch.zeros((self.queue_len, self.hidden_dim)))
            self.register_buffer("swav_queue_n", torch.zeros((), dtype=torch.int32))
            self.register_buffer("swav_it", torch.zeros((), dtype=torch.int32))
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        return self.hidden_dim

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                aug_img: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None,
                info_nce_idx: Optional[torch.Tensor] = None, **_: Any) -> Dict[str, Any]:
        """Training with ``aug_img``: one backbone pass over [img; aug_img],
        ``margin-loss``, ``swav-loss`` and ``info_nce-loss`` as configured,
        ``code`` the image half.  Otherwise the codes of ``img``."""
        if not (training and aug_img is not None):
            with torch.no_grad() if not training else torch.enable_grad():
                feat = self.features(img)
                return {"feat": feat, "code": self.net(feat), "aux": {}}
        b = img.shape[0]
        feat = self.features(torch.cat([img, aug_img], 0))
        semantic = self.net(feat)
        aux: Dict[str, torch.Tensor] = {}
        aux["margin"] = aux["margin-loss"] = margin_ranking_loss(semantic[:b], semantic[b:])
        state: Dict[str, torch.Tensor] = {}
        if self.swav:
            aux["swav-loss"], state = self._swav(semantic)
        if self.use_infonce:
            aux["info_nce"] = aux["info_nce-loss"] = _info_nce(
                semantic[:b], semantic[b:], self.info_nce_kwargs, info_nce_idx, generator)
        return {"feat": feat[:b], "code": semantic[:b], "aux": aux, "state": state}

    def _swav(self, semantic: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        it = self.swav_it
        emb = _l2n(semantic.reshape(-1, self.hidden_dim))
        w = _l2n(self.prototypes)
        w = torch.where(it < self.freeze_protos_niter, w.detach(), w)
        scores = emb @ w.T                                    # (2bhw, K)
        with torch.no_grad():
            q_scores = self.swav_queue @ w.T                  # (L, K)
            q_valid = ((torch.arange(self.queue_len, device=it.device) < self.swav_queue_n)
                       & (it >= self.queue_start_iter))
        loss = cluster_loss(scores, temperature=self.swav_temp, epsilon=self.swav_eps,
                            queue_scores=q_scores, queue_valid=q_valid)
        # the strided subsample of the global batch's codes, [img; view]
        rows = mesh.gather_rows(emb.detach(), parts=2)
        n = rows.shape[0]
        block = max(1, min(self.queue_len // max(1, self.queue_stack_iter), n))
        idx = (torch.arange(block, device=emb.device) * n) // block
        queue = torch.cat([rows[idx], self.swav_queue[:self.queue_len - block]], 0)
        return loss, {"swav_queue": queue,
                      "swav_queue_n": (self.swav_queue_n + block).clamp_max(self.queue_len),
                      "swav_it": it + 1}


# -------------------------------------------------------------------- res

class _AdamState(nn.Module):
    """optax ``scale_by_adam``'s state as buffers: ``mu`` and ``nu``
    shaped as ``like`` (zeros) and the int32 ``count``."""

    def __init__(self, like: nn.Module):
        super().__init__()
        self.mu = copy.deepcopy(like)
        self.nu = copy.deepcopy(like)
        for m in (self.mu, self.nu):
            for t in m.buffers():
                t.zero_()
        self.register_buffer("count", torch.zeros((), dtype=torch.int32))


class ResModel(_Variant):
    """Semantic and local linear-flavour encoders, their concatenation
    aggregated and decoded back to the features (``recon-loss``); in
    training, InfoNCE between the semantic halves of [img; aug_img]
    (``info_nce-loss``) and the CLUB upper bound between the local halves
    (``club-loss``).  The CLUB encoder first takes ``mi_iter`` steps of
    ``clip_by_global_norm(loss.club.clip_grad)`` -> Adam
    (``optimizer.club_enc.lr``, eps 1e-8 outside the square root, bias
    corrected) on the likelihood of the detached local halves
    (``club-enc-loss-first``, ``club-enc-loss``); ``club-loss`` is then
    taken against the updated, detached encoder."""

    consumes_aug = True

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0):
        generator = self._setup(cfg, device, seed)
        m = cfg["model"]
        self.hidden_dim = m.get("hidden_dim", self.feat_dim)
        self.semantic_dim = m.get("semantic_dim", self.feat_dim)
        self.local_dim = m.get("local_dim", self.feat_dim)
        nb = m.get("enc_num_blocks", 1)
        self.semantic = _EncStack(self.feat_dim, self.semantic_dim, nb, "linear", generator)
        self.local = _EncStack(self.feat_dim, self.local_dim, nb, "linear", generator)
        self.agg = Dense(self.semantic_dim + self.local_dim, self.hidden_dim, generator)
        self.dec = _DecStack(self.hidden_dim, self.hidden_dim, self.feat_dim,
                             m.get("dec_num_blocks", 1), m.get("last_norm", False), "linear",
                             generator)
        self.club_enc = as_state(CLUBEncoder(self.local_dim, self.hidden_dim, self.local_dim,
                                             generator))
        self.club_opt = _AdamState(self.club_enc)
        lc = cfg["loss"]
        self.info_nce_kwargs = _info_nce_kwargs(lc, 10)
        club_cfg = lc.get("club", {}) or {}
        self.mi_iter = int(club_cfg.get("mi_iter", 5))
        self.club_clip = float(club_cfg.get("clip_grad", 1.0))
        copt = (cfg.get("optimizer", {}) or {}).get("club_enc", {}) or {}
        self.club_lr = float(copt.get("lr", 3.0e-6))
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        return self.semantic_dim

    def _club_nll(self, club: Dict[str, torch.Tensor], loc_1: torch.Tensor,
                  loc_2: torch.Tensor) -> torch.Tensor:
        """0.01 x the mean over pixels of the summed Gaussian NLL of the
        second half under the encoder's prediction from the first (no
        residual)."""
        mu, logvar = functional_call(self.club_enc, club, (loc_1,), {"residual": False})
        flat2 = loc_2.reshape(-1, self.local_dim)
        return 0.01 * ((flat2 - mu) ** 2 / torch.exp(logvar) + logvar).sum(-1).mean()

    def _club_steps(self, loc_1: torch.Tensor, loc_2: torch.Tensor):
        """The inner loop: returns (encoder, (mu, nu, count), NLL per step).
        In a global program each step's gradient is the ranks' mean, so
        the encoder and its moments stay equal on every rank."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        club = dict(self.club_enc.named_buffers())
        mu = dict(self.club_opt.mu.named_buffers())
        nu = dict(self.club_opt.nu.named_buffers())
        count = self.club_opt.count
        nlls = []
        for _ in range(self.mi_iter):
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_() for k, v in club.items()}
                nll = self._club_nll(leaves, loc_1, loc_2)
                grads = torch.autograd.grad(nll, list(leaves.values()), allow_unused=True)
            nlls.append(nll.detach())
            grads = {k: torch.zeros_like(club[k]) if g is None else g
                     for k, g in zip(leaves, grads)}
            with torch.no_grad():
                if mesh.in_program():
                    # the global mean NLL's gradient: the ranks' mean
                    flat = mesh.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads.values()]))
                    flat = flat / mesh.program_world()
                    grads = {k: v.view_as(g) for (k, g), v in
                             zip(grads.items(), flat.split([g.numel() for g in grads.values()]))}
                norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
                keep = norm < self.club_clip
                count = count + 1
                bc1 = 1 - torch.pow(torch.tensor(b1, device=norm.device), count.float())
                bc2 = 1 - torch.pow(torch.tensor(b2, device=norm.device), count.float())
                new = {}
                for k, g in grads.items():
                    g = torch.where(keep, g, g / norm * self.club_clip)
                    mu[k] = (1 - b1) * g + b1 * mu[k]
                    nu[k] = (1 - b2) * (g * g) + b2 * nu[k]
                    step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                    new[k] = club[k] + (-self.club_lr) * step
                club = new
        return club, (mu, nu, count), nlls

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                aug_img: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None,
                info_nce_idx: Optional[torch.Tensor] = None, **_: Any) -> Dict[str, Any]:
        """Training: one backbone pass over [img; aug_img] (img alone
        without a view), the decoder's BatchNorm on the batch, the losses
        above with a view.  Inference: running averages, no autograd."""
        with torch.no_grad() if not training else torch.enable_grad():
            both = aug_img is not None and training
            feat = self.features(torch.cat([img, aug_img], 0) if both else img)
            semantic = self.semantic(feat)
            local = self.local(feat)
            agg = self.agg(torch.cat([semantic, local], -1), torch.float32)
            updates: BNUpdates = {}
            recon = self.dec(agg, training, updates if training else None)
            aux: Dict[str, torch.Tensor] = {"recon-loss": torch.mean((recon - feat) ** 2)}
            state = self._bn_state(updates)
            if not both:
                return {"feat": feat, "code": semantic, "aux": aux, "state": state}
        b = img.shape[0]
        aux["info_nce"] = aux["info_nce-loss"] = _info_nce(
            semantic[:b], semantic[b:], self.info_nce_kwargs, info_nce_idx, generator)
        d_loc = local.detach()
        club, (mu, nu, count), nlls = self._club_steps(d_loc[:b], d_loc[b:])
        aux["club-enc-loss"], aux["club-enc-loss-first"] = nlls[-1], nlls[0]
        p_mu, p_logvar = functional_call(self.club_enc, club, (local[:b],))
        aux["club-loss"] = club_loss(local[b:], p_mu, p_logvar)
        state.update({f"club_enc.{k}": v for k, v in club.items()})
        state.update({f"club_opt.mu.{k}": v for k, v in mu.items()})
        state.update({f"club_opt.nu.{k}": v for k, v in nu.items()})
        state["club_opt.count"] = count
        return {"feat": feat[:b], "code": semantic[:b], "aux": aux, "state": state}


# ---------------------------------------------------------------- pqgocls

class PQGOCLSModel(_Variant):
    """Student head and EMA teacher head (``model.encoder.momentum``); the
    quantizer runs on the detached teacher output of the view (the
    kernel wherever ``pq_forward`` routes to it: the valid step and the
    predictor; training takes the plain route, as JAX's ``use_pallas:
    auto`` does), its indices are the pseudo-labels of a grouped
    classifier (M, dsub, K) on the student (``cls-loss``), beside
    ``mse-loss`` between the L2-normalised student and teacher, the
    quantizer's ``vq-loss`` and the STEGO loss on the student.  Training
    runs three backbone passes (image, view, kNN positive), as JAX does;
    the momentum update comes before the teacher's forward."""

    consumes_aug = True

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0):
        generator = self._setup(cfg, device, seed)
        m = cfg["model"]
        self.hidden_dim = m["vq"]["embed_dims"][0]
        self.momentum = m.get("encoder", {}).get("momentum", 0.996)
        self.pq_cfg = pq_config_from_dict(m["vq"])
        self.stego_cfg = stego_config_from_dict(cfg["loss"]["stego"])
        self.M, self.K, self.dsub = (self.pq_cfg.num_pq, self.pq_cfg.num_codebook,
                                     self.pq_cfg.sub_dim)
        self.head = ExpansionHead(self.feat_dim, self.hidden_dim, generator)
        pq_params, pq_state = pq_init(generator, self.pq_cfg)
        self.pq = nn.ParameterDict(pq_params)
        self.pq_state = _Buffers(pq_state)
        self.classifier = nn.ParameterDict({
            "w": nn.Parameter(torch.randn((self.M, self.dsub, self.K), generator=generator)
                              / math.sqrt(self.dsub)),
            "b": nn.Parameter(torch.zeros((self.M, self.K)))})
        # the teacher starts as a copy of the student
        self.ema_head = as_state(copy.deepcopy(self.head))
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        return self.hidden_dim

    def _teacher(self, feat: torch.Tensor, head: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            return functional_call(self.ema_head, head, (feat,))

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                aug_img: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None,
                stego_override: Optional[Tuple] = None, **_: Any) -> Dict[str, Any]:
        """Inference (no autograd) returns the student's ``code``, the
        teacher's ``z_q`` and ``indices``; JAX's eval-time ``mse-loss`` and
        ``cls-loss`` go unread there and are not computed.  Training
        needs ``img_pos``; without ``aug_img`` the view is the image."""
        if not training:
            with torch.no_grad():
                feat = self.features(img)
                feat_aug = feat if aug_img is None else self.features(aug_img)
                z_teacher = self._teacher(feat_aug, dict(self.ema_head.named_buffers()))
                z_q, pseudo, aux, _ = pq_forward(z_teacher, dict(self.pq),
                                                 self.pq_state.as_dict(), self.pq_cfg)
                return {"feat": feat, "code": self.head(feat), "z_q": z_q,
                        "indices": pseudo, "aux": aux}
        if img_pos is None:
            raise ValueError("training forward requires img_pos")
        if self.dropout and generator is None:
            raise ValueError("training with dropout requires a generator")

        def drop(f):
            return dropout2d(generator, f, self.drop_prob) if self.dropout else f

        feat_clean = self.features(img)
        feat = drop(feat_clean)
        z_student = self.head(feat)
        feat_aug = drop(feat_clean if aug_img is None else self.features(aug_img))
        m = self.momentum
        student = dict(self.head.named_parameters())
        with torch.no_grad():
            ema = {k: t * m + student[k].detach() * (1.0 - m)
                   for k, t in self.ema_head.named_buffers()}
        z_teacher = self._teacher(feat_aug, ema)
        z_q, pseudo, aux, pq_state = pq_forward(z_teacher, dict(self.pq),
                                                self.pq_state.as_dict(), self.pq_cfg,
                                                training=True, generator=generator)
        aux["mse-loss"] = torch.mean((_l2n(z_student) - _l2n(z_teacher)) ** 2)
        feat_pos = drop(self.features(img_pos))
        code_pos = self.head(feat_pos)
        aux["stego-loss"] = stego_loss(generator, feat, feat_pos, z_student, code_pos,
                                       self.stego_cfg, sample_override=stego_override)
        zs = z_student.reshape(-1, self.M, self.dsub)
        logits = torch.einsum("nmd,mdk->nmk", zs, self.classifier["w"]) + self.classifier["b"]
        labels = pseudo.reshape(-1, self.M).long()
        log_p = torch.log_softmax(logits, dim=-1)
        aux["cls-loss"] = -torch.gather(log_p, -1, labels[..., None]).mean()
        state = {f"pq_state.{k}": v for k, v in pq_state.items()}
        state.update({f"ema_head.{k}": v for k, v in ema.items()})
        return {"feat": feat, "code": z_student, "z_q": z_q, "indices": pseudo, "aux": aux,
                "state": state}


# ------------------------------------------------------------------ hihi

class _UnSegNet(nn.Module):
    """UnSeg's trainable torso: the linear-flavour encoder ``enc``, the
    projections ``vq_in_{i}`` into each quantizer (LeakyReLU 0.1 first;
    biasless unless ``vq_in_bias``), ``vq_out_{i}`` from ``concat(f,
    z_q)`` to the next link, ``agg`` over the quantized features (their
    ``concat`` or ``sum``) and the linear-flavour BatchNorm decoder
    ``dec`` back to ``feat_dim``."""

    def __init__(self, feat_dim: int, hidden_dim: int, embed_dims: Tuple[int, ...],
                 enc_num_blocks: int, dec_num_blocks: int, agg_type: str, last_norm: bool,
                 vq_in_bias: bool, generator: torch.Generator):
        super().__init__()
        self.agg_type = agg_type
        self.enc = _EncStack(feat_dim, hidden_dim, enc_num_blocks, "linear", generator)
        for i, e in enumerate(embed_dims):
            setattr(self, f"vq_in_{i}", Dense(hidden_dim, e, generator, bias=vq_in_bias))
            if i < len(embed_dims) - 1:
                setattr(self, f"vq_out_{i}", Dense(hidden_dim + e, hidden_dim, generator))
        agg_in = sum(embed_dims) if agg_type == "concat" else embed_dims[0]
        self.agg = Dense(agg_in, hidden_dim, generator)
        self.dec = _DecStack(hidden_dim, hidden_dim, feat_dim, dec_num_blocks, last_norm,
                             "linear", generator)

    def vq_input(self, i: int, f: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"vq_in_{i}")(F.leaky_relu(f, 0.1), torch.float32)

    def vq_output(self, i: int, f: torch.Tensor, z_q: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"vq_out_{i}")(torch.cat([f, z_q], -1), torch.float32)

    def aggregate(self, feat_vqs) -> torch.Tensor:
        x = torch.cat(feat_vqs, -1) if self.agg_type == "concat" else sum(feat_vqs)
        return self.agg(x, torch.float32)


class UnSegModel(_Variant):
    """Encoder -> chain of quantizers -> aggregate -> BatchNorm decoder,
    trained on the reconstruction of the frozen features (``recon-loss``)
    and the quantizers' losses (``vq{i}-loss``, their mean ``vq-loss``).
    Quantizer i has its own ``PQConfig`` from ``vq.num_pq[i]``,
    ``num_codebooks[i]`` and ``embed_dims[i]``.  The quantizers route as
    ``pq_forward`` does: the valid step takes the PQ kernel on CUDA,
    training the plain route (``use_pallas: auto``).  ``vq_in_bias`` puts
    a bias on the input projections (the contra family's)."""

    vq_in_bias = False

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0):
        generator = self._setup(cfg, device, seed)
        m = cfg["model"]
        vq = m["vq"]
        self.hidden_dim = m.get("hidden_dim", self.feat_dim)
        self.embed_dims = tuple(vq["embed_dims"])
        self.num_vq = len(self.embed_dims)
        self.draw_keys = _pq_draw_keys(self.num_vq)
        num_pq = vq.get("num_pq", 1)
        if isinstance(num_pq, int):
            num_pq = [num_pq] * self.num_vq
        self.pq_cfgs = _pq_configs(vq, self.num_vq, num_pq,
                                   use_split=vq.get("use_split", False))
        self.net = _UnSegNet(self.feat_dim, self.hidden_dim, self.embed_dims,
                             m.get("enc_num_blocks", 1), m.get("dec_num_blocks", 1),
                             vq.get("agg_type", "concat"), m.get("last_norm", False),
                             self.vq_in_bias, generator)
        pq = [pq_init(generator, c) for c in self.pq_cfgs]
        self.pq = nn.ModuleList([nn.ParameterDict(p) for p, _ in pq])
        self.pq_state = nn.ModuleList([_Buffers(s) for _, s in pq])
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        """The probes' input width: ``feat`` probes ``code`` (the
        aggregate, ``hidden_dim``; JAX's says ``feat_dim``, which only
        works where the two are equal), ``vq{i}`` quantizer i's output."""
        if output_type == "feat":
            return self.hidden_dim
        return self.embed_dims[int(output_type[2:])]

    @property
    def needs_data_init(self) -> bool:
        return any(needs_data_init(c) for c in self.pq_cfgs)

    @torch.no_grad()
    def data_init(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                  **draws: Any) -> Dict[str, torch.Tensor]:
        """The first batch's codebook init, chained through the quantizers
        in forward order: each clusters its own input, the next link fed
        by the eval quantization with the codebook just made.  Returns the
        new tensors by name (``Trainer.data_init`` copies them in)."""
        net = self.net
        f = net.enc(self.features(img))
        new: Dict[str, torch.Tensor] = {}
        for i, c in enumerate(self.pq_cfgs):
            fi = net.vq_input(i, f)
            upd, p, s = pq_data_init_named(fi.reshape(-1, c.num_pq, c.sub_dim), dict(self.pq[i]),
                                           self.pq_state[i].as_dict(), c, generator, draws, i,
                                           f"pq.{i}.", f"pq_state.{i}.")
            new.update(upd)
            if i < self.num_vq - 1:
                z_q, _, _, _ = pq_forward(fi, p, s, c)
                f = net.vq_output(i, f, z_q)
        return new

    def _chain(self, feat: torch.Tensor, training: bool, want_prob: Optional[bool],
               generator: Optional[torch.Generator], draws: Dict[str, Any], usage: bool,
               parts: int = 1):
        """The encoder and the chain of quantizers: (f, feat_vqs, aux,
        quantizer states, distance softmaxes); ``parts``: the batch blocks
        stacked in ``feat``."""
        net = self.net
        f = net.enc(feat)
        aux: Dict[str, torch.Tensor] = {}
        feat_vqs, pq_states, probs = [], [], []
        for i, c in enumerate(self.pq_cfgs):
            fi = net.vq_input(i, f)
            z_q, _, pq_aux, new_s = pq_forward(fi, dict(self.pq[i]), self.pq_state[i].as_dict(),
                                               c, training=training, want_prob=want_prob,
                                               generator=generator, parts=parts,
                                               **_pq_draws(draws, i))
            pq_states.append(new_s)
            feat_vqs.append(z_q)
            probs.append(pq_aux.get("distance_prob"))
            aux[f"vq{i}-loss"] = pq_aux["vq-loss"]
            if usage and "codebook-usage" in pq_aux:
                aux[f"vq{i}-usage"] = pq_aux["codebook-usage"]
            if i < self.num_vq - 1:
                f = net.vq_output(i, f, z_q)
        return feat_vqs, aux, pq_states, probs

    def _decode(self, feat: torch.Tensor, feat_vqs, aux, training: bool):
        """Aggregate and decode: (agg, BatchNorm updates); ``recon-loss``
        and ``vq-loss`` into ``aux``."""
        agg = self.net.aggregate(feat_vqs)
        updates: BNUpdates = {}
        recon = self.net.dec(agg, training, updates if training else None)
        aux["recon-loss"] = torch.mean((recon - feat) ** 2)
        aux["vq-loss"] = sum(aux[f"vq{i}-loss"] for i in range(self.num_vq)) / self.num_vq
        return agg, updates

    def _state(self, pq_states, updates: BNUpdates) -> Dict[str, torch.Tensor]:
        state = {f"pq_state.{i}.{k}": v for i, new_s in enumerate(pq_states)
                 for k, v in new_s.items()}
        state.update(self._bn_state(updates))
        return state

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                training: bool = False, generator: Optional[torch.Generator] = None,
                **draws: Any) -> Dict[str, Any]:
        """``feat``, ``code`` (the aggregate), ``z_q`` (the first
        quantizer's output), ``feat_vqs`` and ``aux`` (``vq{i}-loss``,
        ``vq{i}-usage`` in training, ``vq-loss``, ``recon-loss``).
        Training: BatchNorm on the batch, the new quantizer and BatchNorm
        state under ``state``; the quantizers' draws from ``generator``
        unless ``gumbel_<i>`` / ``split_noise_<i>`` give them.  Inference:
        running averages, no autograd."""
        with torch.no_grad() if not training else torch.enable_grad():
            feat = self.features(img)
            feat_vqs, aux, pq_states, _ = self._chain(feat, training, None, generator, draws,
                                                      usage=True)
            agg, updates = self._decode(feat, feat_vqs, aux, training)
        out = {"feat": feat, "code": agg, "z_q": feat_vqs[0], "feat_vqs": feat_vqs, "aux": aux}
        if training:
            out["state"] = self._state(pq_states, updates)
        return out


# ---------------------------------------------------------------- contra

class ContraModel(UnSegModel):
    """UnSeg's chain (input projections with a bias) over [img; aug_img]:
    each quantizer computes its distance softmax in training
    (``want_prob``), ``contra-loss-pos`` is the JSD of the first
    quantizer's between the halves and ``contra-loss-neg`` the last's;
    the outputs are the image half's.  No usage terms, as in JAX."""

    consumes_aug = True
    vq_in_bias = True

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                aug_img: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None, **draws: Any) -> Dict[str, Any]:
        with torch.no_grad() if not training else torch.enable_grad():
            b = img.shape[0]
            both = training and aug_img is not None
            feat = self.features(torch.cat([img, aug_img], 0) if both else img)
            feat_vqs, aux, pq_states, probs = self._chain(feat, training, training, generator,
                                                          draws, usage=False,
                                                          parts=2 if both else 1)
            agg, updates = self._decode(feat, feat_vqs, aux, training)
            if both:
                aux["contra-loss-pos"] = _halves_jsd(probs[0], self.pq_cfgs[0])
                aux["contra-loss-neg"] = _halves_jsd(probs[-1], self.pq_cfgs[-1])
        out = {"feat": feat[:b], "code": agg[:b], "z_q": feat_vqs[0][:b],
               "feat_vqs": [v[:b] for v in feat_vqs], "aux": aux}
        if training:
            out["state"] = self._state(pq_states, updates)
        return out


# ------------------------------------------------------------------- new

class _NewVQNet(nn.Module):
    """NewVQ's torso: the module-flavour encoder ``enc`` to
    ``hidden_dim`` and the module-flavour BatchNorm decoder ``dec`` back
    to ``feat_dim``."""

    def __init__(self, feat_dim: int, hidden_dim: int, enc_num_blocks: int,
                 dec_num_blocks: int, generator: torch.Generator):
        super().__init__()
        self.enc = _EncStack(feat_dim, hidden_dim, enc_num_blocks, "module", generator)
        self.dec = _DecStack(hidden_dim, hidden_dim, feat_dim, dec_num_blocks, False, "module",
                             generator)


class NewVQModel(_Variant):
    """Encoder -> one quantizer -> BatchNorm decoder: ``recon-loss`` of
    the frozen features over both views, the quantizer's ``vq-loss``, and
    InfoNCE between the (image, view) halves of the code
    (``info_nce-loss``).  ``model.stage: 1`` (with ``model.n_kmeans``;
    ``eval.output_type: feat``) replaces the training forward: k-means
    (10 Lloyd steps from k-means++ seeds, k = ``num_codebook``) over the
    batch's feature pixels, the ``n_kmeans`` pixels nearest each centroid,
    and the quantizer and decoder on those rows only.  The quantizer
    routes as ``pq_forward`` does (the kernel in the valid step on CUDA,
    the plain route in training)."""

    consumes_aug = True

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0):
        generator = self._setup(cfg, device, seed)
        m = cfg["model"]
        vq = m["vq"]
        self.hidden_dim = vq["embed_dims"][0]
        num_pq = vq.get("num_pq", 1)
        if isinstance(num_pq, (list, tuple)):
            num_pq = num_pq[0]
        self.pq_cfg = PQConfig(
            num_pq=num_pq, num_codebook=vq["num_codebooks"][0], embed_dim=self.hidden_dim,
            vq_type=vq.get("vq_type", "param"),
            assign_precision=vq.get("assign_precision", "exact"), beta=vq.get("beta", 0.25),
            normalize=vq.get("normalize", "none"),
            use_weighted_sum=vq.get("use_weighted_sum", False),
            use_restart=vq.get("use_restart", False),
            need_initialized=vq.get("need_initialized", "none"),
            jsd_ts=(cfg["loss"].get("jsd", {}) or {}).get("temperature", 1.0))
        self.net = _NewVQNet(self.feat_dim, self.hidden_dim, m.get("enc_num_blocks", 1),
                             m.get("dec_num_blocks", 1), generator)
        pq_params, pq_state = pq_init(generator, self.pq_cfg)
        self.pq = nn.ParameterDict(pq_params)
        self.pq_state = _Buffers(pq_state)
        self.stage = int(m.get("stage", 0))
        self.n_kmeans = int(m.get("n_kmeans", 100))
        self.info_nce_kwargs = _info_nce_kwargs(cfg["loss"], 10)
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        """``hidden_dim``: ``feat`` probes ``code``, the encoder's output
        (JAX's says ``feat_dim``, which only works where the two are
        equal; stage 1 at the config's widths needs this), ``vq0`` z_q."""
        return self.hidden_dim

    @property
    def needs_data_init(self) -> bool:
        return needs_data_init(self.pq_cfg)

    @torch.no_grad()
    def data_init(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                  **draws: Any) -> Dict[str, torch.Tensor]:
        """The first batch's codebook init on the encoder's output of
        ``img``: the new tensors by name."""
        c = self.pq_cfg
        feat = self.net.enc(self.features(img))
        return pq_data_init_named(feat.reshape(-1, c.num_pq, c.sub_dim), dict(self.pq),
                                  self.pq_state.as_dict(), c, generator, draws, 0, "pq.",
                                  "pq_state.")[0]

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                aug_img: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None,
                info_nce_idx: Optional[torch.Tensor] = None,
                kmeans_first: Optional[torch.Tensor] = None,
                kmeans_gumbel: Optional[torch.Tensor] = None, **_: Any) -> Dict[str, Any]:
        """Training: one backbone pass over [img; aug_img] (img alone
        without a view), the losses above, ``code``, ``z_q`` and
        ``indices`` of the image half, the new quantizer and BatchNorm
        state under ``state``.  Stage 1 takes its k-means draws from
        ``generator`` unless ``kmeans_first`` / ``kmeans_gumbel`` give
        them.  Inference: running averages, no autograd."""
        with torch.no_grad() if not training else torch.enable_grad():
            both = training and aug_img is not None
            b = img.shape[0]
            feat_dino = self.features(torch.cat([img, aug_img], 0) if both else img)
            feat = self.net.enc(feat_dino)
            if training and self.stage == 1:
                return self._stage1(feat_dino, feat, b, generator, kmeans_first,
                                    kmeans_gumbel, 2 if both else 1)
            z_q, idx, aux, pq_state = pq_forward(feat, dict(self.pq), self.pq_state.as_dict(),
                                                 self.pq_cfg, training=training,
                                                 generator=generator, parts=2 if both else 1)
            updates: BNUpdates = {}
            recon = self.net.dec(z_q, training, updates if training else None)
            aux["recon-loss"] = torch.mean((recon - feat_dino) ** 2)
        out = {"feat": feat_dino[:b], "code": feat, "z_q": z_q, "indices": idx, "aux": aux}
        if both:
            aux["info_nce"] = aux["info_nce-loss"] = _info_nce(
                feat[:b], feat[b:], self.info_nce_kwargs, info_nce_idx, generator)
            out.update(code=feat[:b], z_q=z_q[:b], indices=idx[:b])
        if training:
            out["state"] = {**{f"pq_state.{k}": v for k, v in pq_state.items()},
                            **self._bn_state(updates)}
        return out

    def _stage1(self, feat_dino: torch.Tensor, feat: torch.Tensor, b: int,
                generator: Optional[torch.Generator], first: Optional[torch.Tensor],
                gumbel_noise: Optional[torch.Tensor], parts: int) -> Dict[str, Any]:
        """The stage-1 forward.  In a global program the k-means and the
        selection run alike on every rank over the gathered rows of the
        global batch (rank 0's selection kept), and each rank runs the
        quantizer and the decoder on its equal share of the selected rows,
        so that the losses are each rank's share of the global
        selection's and BatchNorm's statistics the global selection's; the
        encoder's gradient goes back to the rows' owners."""
        flat_dino = mesh.gather_rows(feat_dino.reshape(-1, self.feat_dim), parts)
        flat = mesh.gather_rows(feat.reshape(-1, self.hidden_dim), parts)
        with torch.no_grad():
            cents, _ = kmeans(flat_dino, k=self.pq_cfg.num_codebook, n_iters=10,
                              generator=generator, first=first, gumbel_noise=gumbel_noise)
            d2 = ((flat_dino * flat_dino).sum(-1)[None, :]
                  + (cents * cents).sum(-1)[:, None] - 2.0 * cents @ flat_dino.T)  # (K, n)
            sel = mesh.broadcast_(torch.topk(-d2, self.n_kmeans, dim=-1).indices.reshape(-1))
            del d2
        if sel.shape[0] % mesh.program_world():
            raise ValueError(f"stage 1 splits its {sel.shape[0]} selected rows (num_codebook x "
                             f"n_kmeans) evenly over {mesh.program_world()} ranks")
        mine = mesh.local_rows(sel)
        z_q_s, idx_s, aux, pq_state = pq_forward(flat[mine], dict(self.pq),
                                                 self.pq_state.as_dict(), self.pq_cfg,
                                                 training=True, generator=generator)
        updates: BNUpdates = {}
        recon = self.net.dec(z_q_s, True, updates)
        aux["recon-loss"] = torch.mean((recon - flat_dino[mine]) ** 2)
        state = {**{f"pq_state.{k}": v for k, v in pq_state.items()}, **self._bn_state(updates)}
        return {"feat": feat_dino[:b], "code": feat[:b], "z_q": z_q_s, "indices": idx_s,
                "aux": aux, "state": state, "selected": sel}


# ------------------------------------------------------------------- spq

class SPQModel(_Variant):
    """A Dense encoder and soft product quantization: one (K, M d)
    xavier-uniform ``codebook`` split into M books; each pixel's book
    vector takes the softmax(-d^2 tau) weighted sum of the book's
    codewords (tau = 1).  Training with a view: ``jsd``, the JSD between
    the halves' assignments averaged over the books, and InfoNCE between
    the halves' codes (``info_nce-loss``).  No state."""

    consumes_aug = True

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0):
        generator = self._setup(cfg, device, seed)
        vq = cfg["model"]["vq"]
        self.hidden_dim = vq["embed_dims"][0]
        num_pq = vq.get("num_pq", 1)
        self.num_books = num_pq[0] if isinstance(num_pq, (list, tuple)) else num_pq
        self.num_codebook = vq["num_codebooks"][0]
        self.tau_q = 1.0
        self.info_nce_kwargs = _info_nce_kwargs(cfg["loss"], 10)
        self.enc = Dense(self.feat_dim, self.hidden_dim, generator)
        bound = math.sqrt(6.0 / (self.num_codebook + self.hidden_dim))
        self.codebook = nn.Parameter(
            torch.rand((self.num_codebook, self.hidden_dim), generator=generator) * 2 * bound
            - bound)
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        """``hidden_dim``: ``feat`` probes ``code``, the encoder's output
        (JAX's says ``feat_dim``, which only works where the two are
        equal), ``vq0`` z_q."""
        return self.hidden_dim

    def soft_quantize(self, z: torch.Tensor, codebook: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z (..., M d) -> (z_q (..., M d), soft (n, M, K)), in f32."""
        lead = z.shape[:-1]
        dsub = self.hidden_dim // self.num_books
        zb = z.reshape(-1, self.num_books, dsub).float()
        cb = codebook.float().reshape(self.num_codebook, self.num_books, dsub).transpose(0, 1)
        cross = torch.bmm(zb.transpose(0, 1), cb.transpose(1, 2)).transpose(0, 1)  # (n, M, K)
        d2 = (zb * zb).sum(-1)[..., None] + (cb * cb).sum(-1)[None] - 2.0 * cross
        soft = torch.softmax(-d2 * self.tau_q, dim=-1)
        zq = torch.bmm(soft.transpose(0, 1), cb).transpose(0, 1)            # (n, M, dsub)
        return zq.reshape(*lead, self.hidden_dim), soft

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                aug_img: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None,
                info_nce_idx: Optional[torch.Tensor] = None, **_: Any) -> Dict[str, Any]:
        """Training with a view: one backbone pass over [img; aug_img],
        ``jsd`` and ``info_nce-loss``, ``code`` and ``z_q`` of the image
        half.  Otherwise the codes of ``img`` and no loss; inference
        without autograd."""
        with torch.no_grad() if not training else torch.enable_grad():
            both = training and aug_img is not None
            b = img.shape[0]
            feat_dino = self.features(torch.cat([img, aug_img], 0) if both else img)
            feat = self.enc(feat_dino, torch.float32)
            z_q, soft = self.soft_quantize(feat, self.codebook)
            aux: Dict[str, torch.Tensor] = {}
            if both:
                half = soft.shape[0] // 2
                # the batchmean JSD sums over the books: their mean is / M
                aux["jsd"] = jsd_loss(soft[:half], soft[half:]) / self.num_books
                aux["info_nce"] = aux["info_nce-loss"] = _info_nce(
                    feat[:b], feat[b:], self.info_nce_kwargs, info_nce_idx, generator)
        return {"feat": feat_dino[:b], "code": feat[:b], "z_q": z_q[:b], "aux": aux,
                "state": {}}


# ------------------------------------------------------------------- vae

class _VAENet(nn.Module):
    """The VAE's trainable torso: the linear-flavour bottom encoder
    ``enc_bottom``; the top encoder (ReLU, the strided 4x4 ``enc_top_conv``
    to ``hidden_dim // 4`` at half resolution, ReLU, ``enc_top_out`` back
    to ``hidden_dim``); the biasless ``vq_in_0`` after ReLU; the top
    decoder ``dec_top_in`` -> ``dec_top_res_{i}`` -> ReLU -> ``dec_top_up``
    (a transposed 4x4 back to full resolution); ``aggregate`` over
    [relu(bottom features); decoded top], the second quantizer's input;
    ``upsample_t`` lifting the quantized top; and the decoder ``dec_in``
    -> ``dec_res_{i}`` -> ReLU -> ``dec_out`` (-> LayerNorm ``dec_norm``
    with ``last_norm``)."""

    def __init__(self, feat_dim: int, hidden_dim: int, embed_dims: Tuple[int, int],
                 enc_num_blocks: int, dec_num_blocks: int, last_norm: bool, agg_type: str,
                 generator: torch.Generator):
        super().__init__()
        e0, e1 = embed_dims
        g = generator
        self.dec_num_blocks = dec_num_blocks
        self.enc_bottom = _EncStack(feat_dim, hidden_dim, enc_num_blocks, "linear", g)
        self.enc_top_conv = Conv2d(hidden_dim, hidden_dim // 4, g, k=4, stride=2, padding=1)
        self.enc_top_out = Dense(hidden_dim // 4, hidden_dim, g)
        self.vq_in_0 = Dense(hidden_dim, e0, g, bias=False)
        self.dec_top_in = Dense(e0, e0 // 4, g)
        for i in range(dec_num_blocks):
            setattr(self, f"dec_top_res_{i}", ReLUResBlock(e0 // 4, e0 // 4, g))
        self.dec_top_up = ConvTranspose2dTorch(e0 // 4, e0, g)
        self.upsample_t = ConvTranspose2dTorch(e0, e0, g)
        self.aggregate = Dense(hidden_dim + e0, e1, g)
        self.dec_in = Dense(e0 + e1 if agg_type == "concat" else e1, hidden_dim, g)
        for i in range(dec_num_blocks):
            setattr(self, f"dec_res_{i}", ReLUResBlock(hidden_dim, hidden_dim // 4, g))
        self.dec_out = Dense(hidden_dim, feat_dim, g)
        self.dec_norm = nn.LayerNorm(feat_dim, eps=1e-6) if last_norm else None

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bottom features at full resolution, top features at half)."""
        fb = self.enc_bottom(x)
        h = torch.relu(self.enc_top_conv(torch.relu(fb)))
        return fb, self.enc_top_out(h, torch.float32)

    def vq0_input(self, ft: torch.Tensor) -> torch.Tensor:
        return self.vq_in_0(torch.relu(ft), torch.float32)

    def bottom_input(self, fb: torch.Tensor, zq0: torch.Tensor) -> torch.Tensor:
        """The decoded quantized top, concatenated with relu(fb) (the
        reference's in-place ReLU rectified the bottom features it
        reuses), through ``aggregate``."""
        d = self.dec_top_in(zq0, torch.float32)
        for i in range(self.dec_num_blocks):
            d = getattr(self, f"dec_top_res_{i}")(d)
        d = self.dec_top_up(torch.relu(d))
        return self.aggregate(torch.cat([torch.relu(fb), d], -1), torch.float32)

    def decode(self, zq0: torch.Tensor, zq1: torch.Tensor, agg_type: str):
        """(the upsampled top, the concatenated or summed codes, recon)."""
        up0 = self.upsample_t(zq0)
        feat = torch.cat([up0, zq1], -1) if agg_type == "concat" else up0 + zq1
        h = self.dec_in(feat, torch.float32)
        for i in range(self.dec_num_blocks):
            h = getattr(self, f"dec_res_{i}")(h)
        recon = self.dec_out(torch.relu(h), torch.float32)
        return up0, feat, recon if self.dec_norm is None else self.dec_norm(recon)


class VAEModel(_Variant):
    """A two-level hierarchy: the top quantizer on a strided encoding, the
    bottom one on the bottom features conditioned on the decoded top, the
    decoder over both (``recon-loss``, ``vq{i}-loss``, their mean
    ``vq-loss``).  Training over [img; aug_img] computes each quantizer's
    distance softmax (``want_prob``): ``contra-loss-pos`` is the JSD of
    the top's between the halves, ``contra-loss-neg`` the bottom's, and
    ``contra-loss`` pos - 0.01 neg.  The valid step takes the PQ kernel on
    CUDA at each level.  ``feat_vqs`` are the upsampled top (at full
    resolution) and the bottom codes; ``z_q`` the bottom codes."""

    consumes_aug = True

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0):
        generator = self._setup(cfg, device, seed)
        m = cfg["model"]
        vq = m["vq"]
        self.hidden_dim = m.get("hidden_dim", self.feat_dim)
        self.embed_dims = tuple(vq["embed_dims"])
        if len(self.embed_dims) != 2:
            raise ValueError("the VAE variant has 2 quantizer levels")
        num_pq = vq.get("num_pq", 1)
        if isinstance(num_pq, int):
            num_pq = [num_pq] * 2
        elif len(num_pq) < 2:
            num_pq = list(num_pq) * 2
        self.draw_keys = _pq_draw_keys(2)
        self.pq_cfgs = _pq_configs(vq, 2, num_pq, use_split=vq.get("use_split", False),
                                   use_weighted_sum=vq.get("use_weighted_sum", False))
        self.agg_type = vq.get("agg_type", "concat")
        self.net = _VAENet(self.feat_dim, self.hidden_dim, self.embed_dims,
                           m.get("enc_num_blocks", 1), m.get("dec_num_blocks", 1),
                           m.get("last_norm", False), self.agg_type, generator)
        pq = [pq_init(generator, c) for c in self.pq_cfgs]
        self.pq = nn.ModuleList([nn.ParameterDict(p) for p, _ in pq])
        self.pq_state = nn.ModuleList([_Buffers(s) for _, s in pq])
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        """``feat`` probes ``code``, the decoder's input (JAX's says
        ``feat_dim``), ``vq{i}`` level i's codes."""
        if output_type == "feat":
            return sum(self.embed_dims) if self.agg_type == "concat" else self.embed_dims[1]
        return self.embed_dims[int(output_type[2:])]

    @property
    def needs_data_init(self) -> bool:
        return any(needs_data_init(c) for c in self.pq_cfgs)

    @torch.no_grad()
    def data_init(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                  **draws: Any) -> Dict[str, torch.Tensor]:
        """The first batch's codebook init of both levels in forward order:
        the bottom quantizer clusters its input given the top's new
        codebook.  Returns the new tensors by name."""
        net = self.net
        fb, ft = net.encode(self.features(img))
        f0 = net.vq0_input(ft)
        c0, c1 = self.pq_cfgs
        new, p0, s0 = pq_data_init_named(f0.reshape(-1, c0.num_pq, c0.sub_dim), dict(self.pq[0]),
                                         self.pq_state[0].as_dict(), c0, generator, draws, 0,
                                         "pq.0.", "pq_state.0.")
        f1 = net.bottom_input(fb, pq_forward(f0, p0, s0, c0)[0])
        new.update(pq_data_init_named(f1.reshape(-1, c1.num_pq, c1.sub_dim), dict(self.pq[1]),
                                      self.pq_state[1].as_dict(), c1, generator, draws, 1,
                                      "pq.1.", "pq_state.1.")[0])
        return new

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                aug_img: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None, **draws: Any) -> Dict[str, Any]:
        with torch.no_grad() if not training else torch.enable_grad():
            b = img.shape[0]
            both = training and aug_img is not None
            feat = self.features(torch.cat([img, aug_img], 0) if both else img)
            net = self.net

            def quantize(i: int, x: torch.Tensor):
                return pq_forward(x, dict(self.pq[i]), self.pq_state[i].as_dict(),
                                  self.pq_cfgs[i], training=training, want_prob=training,
                                  generator=generator, parts=2 if both else 1,
                                  **_pq_draws(draws, i))

            fb, ft = net.encode(feat)
            zq0, _, aux0, s0 = quantize(0, net.vq0_input(ft))
            zq1, _, aux1, s1 = quantize(1, net.bottom_input(fb, zq0))
            up0, agg, recon = net.decode(zq0, zq1, self.agg_type)
            aux = {"vq0-loss": aux0["vq-loss"], "vq1-loss": aux1["vq-loss"],
                   "vq-loss": 0.5 * (aux0["vq-loss"] + aux1["vq-loss"]),
                   "recon-loss": torch.mean((recon - feat) ** 2)}
            if both:
                aux["contra-loss-pos"] = _halves_jsd(aux0["distance_prob"], self.pq_cfgs[0])
                aux["contra-loss-neg"] = _halves_jsd(aux1["distance_prob"], self.pq_cfgs[1])
                aux["contra-loss"] = aux["contra-loss-pos"] - 0.01 * aux["contra-loss-neg"]
        out = {"feat": feat[:b], "code": agg[:b], "z_q": zq1[:b],
               "feat_vqs": [up0[:b], zq1[:b]], "aux": aux}
        if training:
            out["state"] = {f"pq_state.{i}.{k}": v for i, new_s in enumerate((s0, s1))
                            for k, v in new_s.items()}
        return out


# ------------------------------------------------------------------ info

class _InfoNet(nn.Module):
    """Info's trainable torso: the linear-flavour encoder ``enc`` at
    ``feat_dim``; per level a biasless ``vq_in_{i}`` with a BatchNorm
    ``vq_in_bn_{i}`` (flax's default momentum, 0.99) into the quantizer
    and ``vq_out_{i}`` + ReLU chained on the running feature;
    ``concat_proj`` over [the quantized levels; the final running
    feature]; the linear-flavour BatchNorm decoder ``dec`` closed by a
    LayerNorm."""

    def __init__(self, feat_dim: int, embed_dims: Tuple[int, ...], enc_num_blocks: int,
                 dec_num_blocks: int, generator: torch.Generator):
        super().__init__()
        g = generator
        self.enc = _EncStack(feat_dim, feat_dim, enc_num_blocks, "linear", g)
        for i, e in enumerate(embed_dims):
            setattr(self, f"vq_in_{i}", Dense(feat_dim, e, g, bias=False))
            setattr(self, f"vq_in_bn_{i}", BatchNorm(e, momentum=0.99))
            setattr(self, f"vq_out_{i}", Dense(feat_dim, feat_dim, g))
        self.concat_proj = Dense(sum(embed_dims) + feat_dim, feat_dim, g)
        self.dec = _DecStack(feat_dim, feat_dim, feat_dim, dec_num_blocks, True, "linear", g)

    def vq_input(self, i: int, f: torch.Tensor, train: bool,
                 updates: Optional[BNUpdates] = None) -> torch.Tensor:
        x = getattr(self, f"vq_in_{i}")(f, torch.float32)
        return getattr(self, f"vq_in_bn_{i}")(x, train, updates)

    def vq_output(self, i: int, f: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, f"vq_out_{i}")(f, torch.float32))


class InfoModel(_Variant):
    """Encoder -> per level {BatchNorm'd projection -> quantizer; the
    running feature through ``vq_out_{i}``} -> [quantized levels; final
    running feature] -> ``concat_proj`` -> decoder with a LayerNorm
    (``recon-loss``, ``vq{i}-loss``, ``vq{i}-usage``, ``vq-loss``).  The
    quantizers have M = 1; with ``use_gumbel`` training assigns by the
    Gumbel argmax (drawn from ``generator`` unless ``gumbel_<i>`` gives
    it), and even the valid step keeps the plain route, as in JAX."""

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0):
        generator = self._setup(cfg, device, seed)
        m = cfg["model"]
        vq = m["vq"]
        self.embed_dims = tuple(vq["embed_dims"])
        self.num_vq = len(self.embed_dims)
        self.draw_keys = _pq_draw_keys(self.num_vq)
        self.pq_cfgs = _pq_configs(vq, self.num_vq, [1] * self.num_vq)
        self.net = _InfoNet(self.feat_dim, self.embed_dims, m.get("enc_num_blocks", 1),
                            m.get("dec_num_blocks", 1), generator)
        pq = [pq_init(generator, c) for c in self.pq_cfgs]
        self.pq = nn.ModuleList([nn.ParameterDict(p) for p, _ in pq])
        self.pq_state = nn.ModuleList([_Buffers(s) for _, s in pq])
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        """``feat``: the decoder's input, ``feat_dim``; ``vq{i}``: level i's
        width, the final running feature's (``feat_dim``) past the last."""
        if output_type == "feat":
            return self.feat_dim
        i = int(output_type[2:])
        return self.embed_dims[i] if i < self.num_vq else self.feat_dim

    @property
    def needs_data_init(self) -> bool:
        return any(needs_data_init(c) for c in self.pq_cfgs)

    @torch.no_grad()
    def data_init(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                  **draws: Any) -> Dict[str, torch.Tensor]:
        """The first batch's codebook init: each level clusters its input
        (the BatchNorm at its running averages); the running feature does
        not depend on the codebooks."""
        net = self.net
        f = net.enc(self.features(img))
        new: Dict[str, torch.Tensor] = {}
        for i, c in enumerate(self.pq_cfgs):
            fi = net.vq_input(i, f, False)
            new.update(pq_data_init_named(fi.reshape(-1, c.num_pq, c.sub_dim), dict(self.pq[i]),
                                          self.pq_state[i].as_dict(), c, generator, draws, i,
                                          f"pq.{i}.", f"pq_state.{i}.")[0])
            f = net.vq_output(i, f)
        return new

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                training: bool = False, generator: Optional[torch.Generator] = None,
                **draws: Any) -> Dict[str, Any]:
        with torch.no_grad() if not training else torch.enable_grad():
            feat = self.features(img)
            net = self.net
            f = net.enc(feat)
            updates: BNUpdates = {}
            aux: Dict[str, torch.Tensor] = {}
            feat_vqs, pq_states = [], []
            for i, c in enumerate(self.pq_cfgs):
                fi = net.vq_input(i, f, training, updates if training else None)
                z_q, _, pq_aux, new_s = pq_forward(fi, dict(self.pq[i]),
                                                   self.pq_state[i].as_dict(), c,
                                                   training=training, generator=generator,
                                                   **_pq_draws(draws, i))
                pq_states.append(new_s)
                feat_vqs.append(z_q)
                aux[f"vq{i}-loss"] = pq_aux["vq-loss"]
                if "codebook-usage" in pq_aux:
                    aux[f"vq{i}-usage"] = pq_aux["codebook-usage"]
                f = net.vq_output(i, f)
            feat_vqs.append(f)
            agg = net.concat_proj(torch.cat(feat_vqs, -1), torch.float32)
            recon = net.dec(agg, training, updates if training else None)
            aux["recon-loss"] = torch.mean((recon - feat) ** 2)
            aux["vq-loss"] = sum(aux[f"vq{i}-loss"] for i in range(self.num_vq)) / self.num_vq
        out = {"feat": feat, "code": agg, "z_q": feat_vqs[0], "feat_vqs": feat_vqs, "aux": aux}
        if training:
            out["state"] = {f"pq_state.{i}.{k}": v for i, new_s in enumerate(pq_states)
                            for k, v in new_s.items()}
            out["state"].update(self._bn_state(updates))
        return out


# ------------------------------------------------------------------- ema

class EMAModel(_Variant):
    """A student head (``head``, to ``hidden_dim``) and its momentum
    teacher (``ema_head``, state), a trainable ``centroid`` per cluster
    (N(0, 1) init) and a fixed-size memory ``queue`` per cluster.
    Training: channel dropout on both views (keep masks from
    ``generator`` unless ``dropout_keep`` (2, b, 1, 1, C) gives them), the
    teacher moved toward the student before its forward on the view,
    ``mse-loss`` between the L2-normalised student and teacher outputs;
    the student's detached output feeds the queue (assignment to the
    normalised centroids, the top-2 distance margin as gate, the
    ``enqueue_k`` widest margins per cluster appended, the oldest entries
    dropped; a bank not yet initialised is seeded from strided student
    pixels); ``info_nce-loss`` (also ``proxy-loss``) the proxy InfoNCE of
    queue samples against the centroids (``proxy_q_idx`` /
    ``proxy_neg_idx`` or drawn from ``generator``).  ``data_init``
    initialises the bank by k-means over the student's output.  Two
    backbone passes per training step (image, view)."""

    consumes_aug = True
    needs_data_init = True
    draw_keys = ("dropout_keep", "proxy_q_idx", "proxy_neg_idx")

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None, seed: int = 0):
        generator = self._setup(cfg, device, seed)
        m = cfg["model"]
        self.hidden_dim = m.get("hidden_dim", 70)
        self.momentum = (m.get("encoder", {}) or {}).get("momentum", 0.996)
        mb = m.get("memory_bank", {}) or {}
        self.n_cluster = mb.get("n_cluster", 27)
        self.queue_size = mb.get("queue_size", 64)
        self.num_support = mb.get("num_support", 16)
        self.enqueue_k = mb.get("enqueue_k", 4)
        self.margin = mb.get("margin", 0.1)
        ince = cfg["loss"].get("info_nce", {}) or {}
        self.proxy_temperature = ince.get("temperature", 1.0)
        self.num_queries = ince.get("num_queries", 16)
        self.num_neg = ince.get("num_neg", 64)
        self.head = SegmentationHead(self.feat_dim, self.hidden_dim, generator)
        self.centroid = nn.Parameter(torch.randn((self.n_cluster, self.hidden_dim),
                                                 generator=generator))
        self.ema_head = as_state(copy.deepcopy(self.head))
        self.register_buffer("queue", torch.zeros((self.n_cluster, self.queue_size,
                                                   self.hidden_dim)))
        self.register_buffer("bank_initialized", torch.zeros((), dtype=torch.int32))
        self.to(self.device)

    def output_dim(self, output_type: str) -> int:
        return self.hidden_dim

    def _nearest(self, z: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
        """(clusters, n) squared distances of rows z to ``cents``."""
        return ((z * z).sum(-1)[None, :] + (cents * cents).sum(-1)[:, None]
                - 2.0 * cents @ z.T)

    @torch.no_grad()
    def data_init(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                  **draws: Any) -> Dict[str, torch.Tensor]:
        """The memory bank from the student's output of ``img`` (no
        dropout): k-means (k = ``n_cluster``, 10 Lloyd steps; its draws
        ``kmeans_first_0`` / ``kmeans_gumbel_0`` where given), the
        ``num_support`` pixels nearest each centroid, their mean as the
        centroid and their tiling as the queue."""
        z = self.head(self.features(img)).reshape(-1, self.hidden_dim)
        cents, _ = kmeans(z, k=self.n_cluster, n_iters=10, generator=generator,
                          first=draws.get("kmeans_first_0"),
                          gumbel_noise=draws.get("kmeans_gumbel_0"))
        idx = torch.topk(-self._nearest(z, cents), self.num_support, dim=-1).indices
        supports = z[idx]                                  # (clusters, support, d)
        reps = -(-self.queue_size // self.num_support)
        return {"centroid": supports.mean(1),
                "queue": supports.repeat(1, reps, 1)[:, :self.queue_size],
                "bank_initialized": torch.ones((), dtype=torch.int32, device=z.device)}

    def _enqueue(self, z_flat: torch.Tensor) -> torch.Tensor:
        """The queue after this batch's student rows ``z_flat`` (n, d)."""
        C, Q, ek = self.n_cluster, self.queue_size, self.enqueue_k
        n = z_flat.shape[0]
        stride = max(1, n // C)
        seed = z_flat[(torch.arange(C, device=z_flat.device) * stride) % n]
        queue = torch.where(self.bank_initialized > 0, self.queue,
                            seed[:, None].expand(C, Q, self.hidden_dim))
        d2 = self._nearest(_l2n(z_flat), _l2n(self.centroid.detach()))       # (C, n)
        assign = d2.argmin(0)
        two = torch.topk(d2.T, 2, dim=-1, largest=False).values           # ascending
        gap = two[:, 1] - two[:, 0]
        own = F.one_hot(assign, C).T.bool()
        score = torch.where(own & (gap > self.margin)[None], gap[None],
                            torch.full_like(d2, -math.inf))
        top_v, top_i = torch.topk(score, ek, dim=-1)
        items = z_flat[top_i]                                              # (C, ek, d)
        v = (top_v > -math.inf).sum(-1, keepdim=True)                      # (C, 1)
        j = torch.arange(Q, device=z_flat.device)[None]
        from_old = (j < Q - v)[..., None]
        old = torch.gather(queue, 1, (j + v).clamp(0, Q - 1)[..., None].expand(C, Q,
                                                                              self.hidden_dim))
        new = torch.gather(items, 1, (j - (Q - v)).clamp(0, ek - 1)[..., None].expand(
            C, Q, self.hidden_dim))
        return torch.where(from_old, old, new)

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                aug_img: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_keep: Optional[torch.Tensor] = None,
                proxy_q_idx: Optional[torch.Tensor] = None,
                proxy_neg_idx: Optional[torch.Tensor] = None, **_: Any) -> Dict[str, Any]:
        if not training:
            with torch.no_grad():
                feat = self.features(img)
                return {"feat": feat, "code": self.head(feat), "aux": {}}

        def drop(f: torch.Tensor, view: int) -> torch.Tensor:
            if not self.dropout:
                return f
            if dropout_keep is not None:
                p = self.drop_prob
                return torch.where(dropout_keep[view].to(f.device), f / (1.0 - p),
                                   torch.zeros((), dtype=f.dtype, device=f.device))
            if generator is None:
                raise ValueError("training with dropout requires a generator or dropout_keep")
            return dropout2d(generator, f, self.drop_prob)

        feat = drop(self.features(img), 0)
        z_student = self.head(feat)
        m = self.momentum
        student = dict(self.head.named_parameters())
        with torch.no_grad():
            ema = {k: t * m + student[k].detach() * (1.0 - m)
                   for k, t in self.ema_head.named_buffers()}
            feat_t = drop(self.features(img if aug_img is None else aug_img), 1)
            z_teacher = functional_call(self.ema_head, ema, (feat_t,))
        s_flat = z_student.reshape(-1, self.hidden_dim)
        t_flat = z_teacher.reshape(-1, self.hidden_dim)
        aux: Dict[str, torch.Tensor] = {"mse-loss": torch.mean((_l2n(s_flat) - _l2n(t_flat)) ** 2)}
        with torch.no_grad():
            # the bank ranks the global batch's rows, alike on every rank
            queue = self._enqueue(mesh.gather_rows(s_flat.detach()))
        C, Q = self.n_cluster, self.queue_size
        if proxy_q_idx is None:
            if generator is None:
                raise ValueError("the proxy loss needs a generator or proxy_q_idx/proxy_neg_idx")
            dev = queue.device
            proxy_q_idx = torch.randint(0, Q, (C, self.num_queries), generator=generator,
                                        device=dev)
            proxy_neg_idx = torch.randint(0, (C - 1) * Q, (C, self.num_queries * self.num_neg),
                                          generator=generator, device=dev)
        aux["info_nce-loss"] = aux["proxy-loss"] = proxy_loss(
            queue, self.centroid, proxy_q_idx.to(queue.device), proxy_neg_idx.to(queue.device),
            temperature=self.proxy_temperature)
        state = {f"ema_head.{k}": v for k, v in ema.items()}
        state.update(queue=queue, bank_initialized=torch.ones_like(self.bank_initialized))
        return {"feat": feat, "code": z_student, "aux": aux, "state": state}
