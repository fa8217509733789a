"""Optimizers and learning-rate schedules.

Counterpart of ``equss_tpu/train/optim.py``, which builds optax chains:

* adam takes the learning rate only (no weight decay);
* adamw decays every parameter with ndim > 1 outside the quantizer
  (``pq``) and ``club_enc`` subtrees (``wd_mask``);
* sgd with momentum 0.9 by default, weight decay added to the gradient
  under the same mask;
* constant and cosine schedules, the cosine one over
  ``max_epochs * (iter_per_epoch // num_accum)`` updates;
* ``clip_grad``: optax's ``clip_by_global_norm``, which scales the
  gradients by max / norm only when norm exceeds max (unlike
  ``torch.nn.utils.clip_grad_norm_``, which divides by norm + 1e-6).

The update rules are ``torch.optim``'s Adam, AdamW and SGD, the same
formulas as optax's adam (eps outside the square root), adamw and sgd
(trace momentum).  Gradient accumulation (``num_accum`` k > 1) is optax's
``MultiSteps(chain(clip, core), every_k_schedule=k)``: each ``step`` is a
micro-step that folds the gradients into their running mean (``acc +
(g - acc) / (mini_step + 1)``, optax's form) and leaves the parameters as
they are, and every k-th clips the mean and updates with it; the schedule
counts updates.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

NO_WD_SUBTREES = ("pq", "club_enc")

NamedParams = Iterable[Tuple[str, torch.nn.Parameter]]


def wd_mask(name: str, param: torch.Tensor) -> bool:
    """True where weight decay applies: ndim > 1 and no dotted part of the
    name is a quantizer or CLUB-encoder subtree."""
    return param.ndim > 1 and not any(part in NO_WD_SUBTREES for part in name.split("."))


def build_schedule(sched_cfg: Dict[str, Any], base_lr: float, iter_per_epoch: int,
                   max_epochs: int, num_accum: int = 1) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first update)."""
    name = sched_cfg.get("name", "constant").lower()
    if name == "constant":
        lr = base_lr * sched_cfg.get("factor", 1.0)
        return lambda count: lr
    if name in ("cos", "cosine"):
        t_max = max(max_epochs * (iter_per_epoch // max(num_accum, 1)), 1)
        alpha = sched_cfg.get("min_lr", 0.0) / max(base_lr, 1e-12)

        def cosine(count: int) -> float:
            c = min(count, t_max)
            decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / t_max)) + alpha
            return base_lr * decayed
        return cosine
    raise ValueError(f"Unsupported scheduler type {name}")


def global_grad_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient present (f32)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


class Optimizer:
    """One optax-style transform over a set of named parameters: optional
    global-norm clipping, then the update rule at the scheduled rate."""

    def __init__(self, named_params: NamedParams, opt_cfg: Dict[str, Any],
                 sched_cfg: Optional[Dict[str, Any]] = None, *,
                 iter_per_epoch: int = 1, max_epochs: int = 1,
                 num_accum: int = 1, clip_grad: Optional[float] = None):
        named = list(named_params)
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        self._names = {id(p): n for n, p in named}
        self._named = named
        self.num_accum = max(int(num_accum), 1)
        # MultiSteps' micro-step within the update and its gradient mean
        self.mini_step = 0
        self.acc: Dict[str, torch.Tensor] = (
            {n: torch.zeros_like(p) for n, p in named} if self.num_accum > 1 else {})
        self.schedule = build_schedule(sched_cfg or {}, opt_cfg["lr"],
                                       iter_per_epoch, max_epochs, num_accum)
        self.clip_grad = clip_grad if clip_grad is not None and clip_grad > 0 else None
        self.count = 0
        name = opt_cfg["name"].lower()
        lr = self.schedule(0)
        wd = opt_cfg.get("weight_decay", 0.0)
        decay = [p for n, p in named if wd_mask(n, p)]
        rest = [p for n, p in named if not wd_mask(n, p)]
        groups = [{"params": g, "weight_decay": w}
                  for g, w in ((decay, wd), (rest, 0.0)) if g]
        if name not in ("adam", "adamw", "sgd"):
            raise ValueError(f"Unsupported optimizer type {name}")
        self.opt: Optional[torch.optim.Optimizer] = None
        if not named:
            # nothing to train (the probe-only model, a missing cluster
            # probe): the schedule still counts its updates, as optax's does
            return
        if name == "adam":
            self.opt = torch.optim.Adam(self.params, lr=lr)
        elif name == "adamw":
            betas = tuple(opt_cfg.get("betas", (0.9, 0.999)))
            self.opt = torch.optim.AdamW(groups, lr=lr, betas=betas)
        elif name == "sgd":
            self.opt = torch.optim.SGD(groups, lr=lr,
                                       momentum=opt_cfg.get("momentum", 0.9))

    def zero_grad(self) -> None:
        if self.opt is not None:
            self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, norm: Optional[torch.Tensor] = None) -> None:
        """Clip (if configured), set the scheduled rate, update.  ``norm``
        is the global gradient norm of this optimizer's parameters where
        the caller has it already.  The clip is a select on the device, as
        optax's, so the step reads nothing back to the host.  With
        ``num_accum`` > 1 a micro-step: the gradients join their mean, and
        only the last micro-step of an update clips that mean and applies
        it (an absent gradient counts as zero, as in optax)."""
        if self.num_accum > 1:
            m = self.mini_step
            for n, p in self._named:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                self.acc[n] = self.acc[n] + (g - self.acc[n]) / (m + 1)
            if m < self.num_accum - 1:
                self.mini_step = m + 1
                return
            for n, p in self._named:
                p.grad = self.acc[n]
                self.acc[n] = torch.zeros_like(p)
            self.mini_step = 0
            norm = None                 # the mean's norm, not the micro-step's
        if self.clip_grad is not None:
            if norm is None:
                norm = global_grad_norm(self.params)
            keep = norm < self.clip_grad
            for p in self.params:
                if p.grad is not None:
                    p.grad.copy_(torch.where(keep, p.grad,
                                             p.grad / norm * self.clip_grad))
        if self.opt is not None:
            lr = self.schedule(self.count)
            for group in self.opt.param_groups:
                group["lr"] = lr
            self.opt.step()
        self.count += 1

    def _index_names(self) -> List[str]:
        """Parameter names in the order ``torch.optim`` numbers them."""
        if self.opt is None:
            return []
        return [self._names[id(p)] for g in self.opt.param_groups for p in g["params"]]

    def state_dict(self) -> Dict[str, Any]:
        """``count`` (the schedule position: updates made) and ``state``,
        each parameter's moments (and Adam's ``step``) by parameter name;
        with ``num_accum`` > 1 also ``mini_step`` and ``acc``, the
        gradient mean by parameter name."""
        out: Dict[str, Any] = {"count": self.count, "state": {}}
        if self.num_accum > 1:
            out.update(mini_step=self.mini_step, acc=dict(self.acc))
        if self.opt is not None:
            names = self._index_names()
            inner = self.opt.state_dict()["state"]
            out["state"] = {names[i]: dict(s) for i, s in inner.items()}
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Load what ``state_dict`` gave, on any device: torch moves each
        moment to its parameter's device."""
        index = {n: i for i, n in enumerate(self._index_names())}
        unknown = sorted(set(sd["state"]) - set(index))
        if unknown:
            raise KeyError(f"optimizer state for unknown parameters {unknown}")
        self.count = int(sd["count"])
        if self.num_accum > 1:
            self.mini_step = int(sd["mini_step"])
            params = dict(self._named)
            self.acc = {n: t.to(params[n].device, params[n].dtype).clone()
                        for n, t in sd["acc"].items()}
        if self.opt is None:
            return
        full = self.opt.state_dict()
        full["state"] = {index[n]: dict(s) for n, s in sd["state"].items()}
        self.opt.load_state_dict(full)


def build_optimizer(named_params: NamedParams, opt_cfg: Dict[str, Any],
                    sched_cfg: Optional[Dict[str, Any]] = None, *,
                    iter_per_epoch: int = 1, max_epochs: int = 1,
                    num_accum: int = 1, clip_grad: Optional[float] = None) -> Optimizer:
    """cfg['optimizer'][x] + cfg['scheduler'][x] -> ``Optimizer``."""
    return Optimizer(named_params, opt_cfg, sched_cfg, iter_per_epoch=iter_per_epoch,
                     max_epochs=max_epochs, num_accum=num_accum, clip_grad=clip_grad)
