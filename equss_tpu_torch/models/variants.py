"""Model variants of the EQUSS skeleton: the first two slices.

Counterpart of ``equss_tpu/models/variants.py``'s shared parts
(``codebook_usage_percentiles``, the backbone plumbing, ``_EncStack`` and
``_DecStack``) and six of its families:

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
  JSD between the views' assignments and InfoNCE.

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
``stego_override`` and NewVQ's ``kmeans_first`` / ``kmeans_gumbel``
replace them.
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
                                          margin_ranking_loss)
from equss_tpu_torch.losses.sinkhorn import cluster_loss
from equss_tpu_torch.losses.stego import stego_loss
from equss_tpu_torch.models.equss import (_Buffers, backbone_settings, pq_config_from_dict,
                                          stego_config_from_dict)
from equss_tpu_torch.models.heads import (BNUpdates, CLUBEncoder, DecResBlock, EncResBlock,
                                          ExpansionHead, LinDecResBlock, LinEncResBlock,
                                          as_state, dropout2d)
from equss_tpu_torch.models.vit import Dense, VisionTransformer, make_vit_config
from equss_tpu_torch.ops.kmeans import kmeans
from equss_tpu_torch.ops.quantizer import PQConfig, pq_forward, pq_init


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

    def _setup(self, cfg: Dict[str, Any], device: DeviceLike, seed: int) -> torch.Generator:
        super().__init__()
        self.device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        pre = cfg["model"]["pretrained"]
        s = backbone_settings(pre)
        self.vit_cfg = make_vit_config(s["model_type"], s["patch_size"],
                                       dtype=s["backbone_dtype"], attn_bf16=s["attn_bf16"],
                                       gelu=s["gelu"])
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
        n = emb.shape[0]
        block = max(1, min(self.queue_len // max(1, self.queue_stack_iter), n))
        idx = (torch.arange(block, device=emb.device) * n) // block
        queue = torch.cat([emb[idx].detach(), self.swav_queue[:self.queue_len - block]], 0)
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
        """The inner loop: returns (encoder, (mu, nu, count), NLL per step)."""
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
                                                training=True)
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
        num_pq = vq.get("num_pq", 1)
        if isinstance(num_pq, int):
            num_pq = [num_pq] * self.num_vq
        self.pq_cfgs = [PQConfig(
            num_pq=num_pq[i], num_codebook=vq["num_codebooks"][i],
            embed_dim=self.embed_dims[i], vq_type=vq.get("vq_type", "param"),
            assign_precision=vq.get("assign_precision", "exact"),
            need_initialized=vq.get("need_initialized", "none"),
            beta=vq.get("beta", 0.25), normalize=vq.get("normalize", "none"),
            use_restart=vq.get("use_restart", False), use_split=vq.get("use_split", False),
            use_gumbel=vq.get("use_gumbel", False), decay=vq.get("decay", 0.99),
            eps=vq.get("eps", 1e-5)) for i in range(self.num_vq)]
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

    def forward(self, img: torch.Tensor, img_pos: Optional[torch.Tensor] = None, *,
                training: bool = False, **_: Any) -> Dict[str, Any]:
        """``feat``, ``code`` (the aggregate), ``z_q`` (the first
        quantizer's output), ``feat_vqs`` and ``aux`` (``vq{i}-loss``,
        ``vq{i}-usage`` in training, ``vq-loss``, ``recon-loss``).
        Training: BatchNorm on the batch, the new quantizer and BatchNorm
        state under ``state``.  Inference: running averages, no
        autograd."""
        with torch.no_grad() if not training else torch.enable_grad():
            feat = self.features(img)
            net = self.net
            f = net.enc(feat)
            aux: Dict[str, torch.Tensor] = {}
            feat_vqs, pq_states = [], []
            for i, c in enumerate(self.pq_cfgs):
                fi = net.vq_input(i, f)
                z_q, _, pq_aux, new_s = pq_forward(fi, dict(self.pq[i]),
                                                   self.pq_state[i].as_dict(), c,
                                                   training=training)
                pq_states.append(new_s)
                feat_vqs.append(z_q)
                aux[f"vq{i}-loss"] = pq_aux["vq-loss"]
                if "codebook-usage" in pq_aux:
                    aux[f"vq{i}-usage"] = pq_aux["codebook-usage"]
                if i < self.num_vq - 1:
                    f = net.vq_output(i, f, z_q)
            agg = net.aggregate(feat_vqs)
            updates: BNUpdates = {}
            recon = net.dec(agg, training, updates if training else None)
            aux["recon-loss"] = torch.mean((recon - feat) ** 2)
            aux["vq-loss"] = sum(aux[f"vq{i}-loss"] for i in range(self.num_vq)) / self.num_vq
        out = {"feat": feat, "code": agg, "z_q": feat_vqs[0], "feat_vqs": feat_vqs, "aux": aux}
        if training:
            out["state"] = {f"pq_state.{i}.{k}": v
                            for i, new_s in enumerate(pq_states) for k, v in new_s.items()}
            out["state"].update(self._bn_state(updates))
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
                                    kmeans_gumbel)
            z_q, idx, aux, pq_state = pq_forward(feat, dict(self.pq), self.pq_state.as_dict(),
                                                 self.pq_cfg, training=training)
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
                gumbel_noise: Optional[torch.Tensor]) -> Dict[str, Any]:
        flat_dino = feat_dino.reshape(-1, self.feat_dim)
        with torch.no_grad():
            cents, _ = kmeans(flat_dino, k=self.pq_cfg.num_codebook, n_iters=10,
                              generator=generator, first=first, gumbel_noise=gumbel_noise)
            d2 = ((flat_dino * flat_dino).sum(-1)[None, :]
                  + (cents * cents).sum(-1)[:, None] - 2.0 * cents @ flat_dino.T)  # (K, n)
            sel = torch.topk(-d2, self.n_kmeans, dim=-1).indices.reshape(-1)
            del d2
        feat_s = feat.reshape(-1, self.hidden_dim)[sel]
        z_q_s, idx_s, aux, pq_state = pq_forward(feat_s, dict(self.pq), self.pq_state.as_dict(),
                                                 self.pq_cfg, training=True)
        updates: BNUpdates = {}
        recon = self.net.dec(z_q_s, True, updates)
        aux["recon-loss"] = torch.mean((recon - flat_dino[sel]) ** 2)
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
