"""One pqgo train step in plain PyTorch, from the weights before it and
the batch it takes: the frozen backbone on [img; img_pos], channel
dropout, the head on both halves, product quantization of the first half
with its codebook and commitment terms, STEGO's loss (arXiv:2203.08414)
on the given samples, the linear probe's cross-entropy at the label's
resolution and the cluster probe's loss on the detached quantized code,
one backward, the model's gradients clipped by their global norm, and
three Adams (torch's and optax's update: eps outside the square root).

The dropout masks are drawn as the program draws them: one
``torch.rand((2b, 1, 1, C))`` a step from a generator on the device
seeded as the trainer's, kept where below 1 - p.  The reference draws
them itself from the same seed; a program that drew them otherwise
would read wrong here.

A run starts from the benchmark's weights with fresh Adams and the
generator seeded, or from a state taken in the middle of a run
(``start``: the trainable leaves, each leaf's Adam moments and step
count, the generator's state), to follow one step of that run.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import model as ref
from perfbench.reference.precision import rnd

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

#: trainable leaves by optimizer, under the names of ``weights.py``
MODEL_LEAVES = ("head.cluster1.weight", "head.cluster1.bias", "head.cluster2_fc1.weight",
                "head.cluster2_fc1.bias", "head.cluster2_fc2.weight", "head.cluster2_fc2.bias",
                "pq.codebook")
CLUSTER_LEAVES = ("probes.cluster_probe.clusters",)
LINEAR_LEAVES = ("probes.linear_probe.linear.weight", "probes.linear_probe.linear.bias")
LEAVES = MODEL_LEAVES + CLUSTER_LEAVES + LINEAR_LEAVES


def grid_sample(t: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """t (b, H, W, C) at STEGO's coordinates (b, s, s, 2), the two query
    axes swapped as STEGO's ``sample`` does: border padding,
    align_corners True."""
    out = F.grid_sample(t.permute(0, 3, 1, 2), coords.transpose(1, 2), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


def correlation(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return torch.einsum("nhwc,nijc->nhwij", rnd(a, prec), rnd(b, prec))


def stego_term(f1, f2, c1, c2, shift: float, s: Dict[str, Any], prec: str) -> torch.Tensor:
    with torch.no_grad():
        fd = correlation(ref.l2n(f1, 1e-10), ref.l2n(f2, 1e-10), prec)
        if s["pointwise"]:
            centered = fd - fd.mean(dim=(3, 4), keepdim=True)
            fd = centered - centered.mean() + fd.mean()
    cd = correlation(ref.l2n(c1, 1e-10), ref.l2n(c2, 1e-10), prec)
    floor = 0.0 if s["zero_clamp"] else -9999.0
    cd = cd.clamp(floor, 0.8) if s["stabilize"] else cd.clamp_min(floor)
    return -cd * (fd - shift)


def stego_loss(feat, feat_pos, code, code_pos, c1, c2, perms, s, prec) -> torch.Tensor:
    f, c = grid_sample(feat, c1), grid_sample(code, c1)
    fp, cp = grid_sample(feat_pos, c2), grid_sample(code_pos, c2)
    intra = stego_term(f, f, c, c, s["pos_intra_shift"], s, prec)
    inter = stego_term(f, fp, c, cp, s["pos_inter_shift"], s, prec)
    neg = torch.cat([stego_term(f, grid_sample(feat[p], c2), c, grid_sample(code[p], c2),
                                s["neg_inter_shift"], s, prec)
                     for p in perms[:s["neg_samples"]]], 0)
    return (s["pos_intra_weight"] * intra.mean() + s["pos_inter_weight"] * inter.mean()
            + s["neg_inter_weight"] * neg.mean())


class ReferenceTrainer:
    """The reference's train state: the trainable leaves (f32, with
    gradients), the frozen backbone's weights, three Adams and the dropout
    generator.  From the benchmark's weights ``W`` and ``dropout_seed``,
    or, where ``start`` is given, from its ``params``, ``m``, ``v``, ``t``
    (each by leaf) and ``generator`` state; the backbone always from
    ``W``."""

    def __init__(self, W: Dict[str, torch.Tensor], cfg: Dict[str, Any], w: Dict[str, int],
                 dropout_seed: int, precs: Dict[str, str],
                 start: Optional[Dict[str, Any]] = None):
        self.cfg, self.w, self.precs = cfg, w, precs
        self.frozen = {k: v for k, v in W.items() if k.startswith("backbone.")}
        src = W if start is None else start["params"]
        self.params = {k: src[k].detach().float().clone().requires_grad_(True) for k in LEAVES}
        if start is None:
            self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.t = {k: 0 for k in LEAVES}
        else:
            self.m = {k: start["m"][k].detach().float().clone() for k in LEAVES}
            self.v = {k: start["v"][k].detach().float().clone() for k in LEAVES}
            self.t = {k: int(start["t"][k]) for k in LEAVES}
        dev = next(iter(W.values())).device
        self.gen = torch.Generator(device=dev)
        if start is None:
            self.gen.manual_seed(dropout_seed)
        else:
            self.gen.set_state(start["generator"])

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One step on a batch already on the device.  Returns ``loss``
        and ``grads`` (each leaf's gradient as its optimizer takes it:
        the model's after the clip)."""
        cfg, w, precs, P = self.cfg, self.w, self.precs, self.params
        W = {**self.frozen, **P}
        b = batch["img"].shape[0]
        with torch.no_grad():
            x = torch.cat([ref.normalize(batch["img"]), ref.normalize(batch["img_pos"])])
            both = torch.cat([ref.dense(W, x[s:s + 16], w, precs["backbone"])
                              for s in range(0, x.shape[0], 16)])
        pre = cfg["model"]["pretrained"]
        if pre.get("dropout", True) and pre.get("drop_prob", 0.1) > 0:
            p = pre.get("drop_prob", 0.1)
            keep = torch.rand((both.shape[0], 1, 1, both.shape[-1]), generator=self.gen,
                              device=both.device) < 1.0 - p
            both = torch.where(keep, both / (1.0 - p), torch.zeros((), device=both.device))
        code_both = ref.head(W, both, precs["head"])
        feat, feat_pos, code, code_pos = both[:b], both[b:], code_both[:b], code_both[b:]

        vq = cfg["model"]["vq"]
        M, hid = w["num_pq"], w["hidden"]
        z = code.reshape(-1, M, hid // M)
        _, zn, zq = ref.pq_assign(z, P["pq.codebook"], precs["pq"])
        vq_loss = (vq.get("book", 1.0) * torch.mean((zq - zn.detach()) ** 2)
                   + vq.get("beta", 0.25) * torch.mean((zn - zq.detach()) ** 2))
        s = cfg["loss"]["stego"]
        stego = stego_loss(feat, feat_pos, code, code_pos, batch["stego_coords1"],
                           batch["stego_coords2"], batch["stego_perms"].long(), s, precs["stego"])
        loss_cfg = cfg["loss"]
        model_loss = (float(loss_cfg.get("stego_weight", 0.0)) * stego
                      + float(loss_cfg.get("vq_weight", 0.0)) * vq_loss)

        zst = (zn + (zq - zn)).detach().reshape(code.shape)
        lin, inner = ref.probe_logits(W, zst, precs["probes"])
        label = batch["label"].long()
        classes = cfg["num_classes"]
        logits = ref.upsample(lin, tuple(label.shape[1:]))
        mask = (label >= 0) & (label < classes)
        ce = -torch.log_softmax(logits, -1).gather(
            -1, torch.where(mask, label, 0)[..., None])[..., 0]
        linear_loss = torch.where(mask, ce, 0.0).sum() / mask.sum().clamp_min(1)
        onehot = F.one_hot(inner.argmax(-1), inner.shape[-1]).float()
        cluster_loss = -(onehot * inner).sum(-1).mean()
        total = model_loss + linear_loss + cluster_loss

        grads = dict(zip(LEAVES, torch.autograd.grad(total, [P[k] for k in LEAVES],
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(P[k]) if g is None else g for k, g in grads.items()}
        clip = cfg.get("train", {}).get("clip_grad", 10.0)
        norm = torch.sqrt(sum((grads[k] ** 2).sum() for k in MODEL_LEAVES))
        if clip and clip > 0 and norm >= clip:
            for k in MODEL_LEAVES:
                grads[k] = grads[k] / norm * clip
        self._adam(grads)
        return {"loss": float(total.detach()), "grads": grads,
                "terms": {"stego": float(stego.detach()), "vq": float(vq_loss.detach()),
                          "linear": float(linear_loss.detach()),
                          "cluster": float(cluster_loss.detach())}}

    @torch.no_grad()
    def _adam(self, grads: Dict[str, torch.Tensor]) -> None:
        opt = self.cfg["optimizer"]
        lrs = {**{k: opt["model"]["lr"] for k in MODEL_LEAVES},
               **{k: opt["cluster"]["lr"] for k in CLUSTER_LEAVES},
               **{k: opt["linear"]["lr"] for k in LINEAR_LEAVES}}
        b1, b2 = BETAS
        for k, p in self.params.items():
            self.t[k] += 1
            bc1, bc2 = 1 - b1 ** self.t[k], 1 - b2 ** self.t[k]
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + ADAM_EPS
            p.sub_(lrs[k] / bc1 * self.m[k] / denom)


def run_steps(W: Dict[str, torch.Tensor], cfg: Dict[str, Any], w: Dict[str, int],
              batches: List[Dict[str, torch.Tensor]], dropout_seed: int,
              precs: Dict[str, str], start: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The reference over ``batches`` (on the device), from the seed's
    weights or from ``start``: each step's loss, the loss terms of each,
    the first step's gradients and the leaves after the last step."""
    tr = ReferenceTrainer(W, cfg, w, dropout_seed, precs, start)
    losses, terms, first = [], [], None
    for i, batch in enumerate(batches):
        out = tr.step(batch)
        losses.append(out["loss"])
        terms.append(out["terms"])
        if i == 0:
            first = {k: g.detach().clone() for k, g in out["grads"].items()}
    return {"losses": losses, "terms": terms, "grads": first,
            "after": {k: v.detach().clone() for k, v in tr.params.items()}}
