"""EQUSS trainer: the train step.

Counterpart of ``equss_tpu/train/trainer.py`` (``TrainConfig``,
``LOSS_WEIGHT_MAP``, ``Trainer.__init__``, ``_model_loss``,
``_select_out``, ``_trainable``, ``_normalize_batch`` and
``_train_step_impl``).  One step runs the model's training forward, the
weighted loss, the probe losses on detached features, one backward, and
three optimizers: the model's (head and codebook; the frozen backbone is
never trained), clipped at ``clip_grad``, and the two probes', unclipped.
A step whose loss or gradients are not finite changes no parameter, no
optimizer state and no quantizer count (``train.skip_nonfinite``): the
quantizer's new ``vq_count`` is computed in the forward and applied only
after that check.

The valid step, ``fit``, data-dependent codebook init and checkpoints
belong to a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from equss_tpu_torch.data.transforms import normalize_images
from equss_tpu_torch.device import DeviceLike, resolve_device
from equss_tpu_torch.eval.probes import Evaluator, EvaluatorConfig
from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig
from equss_tpu_torch.train.optim import build_optimizer, global_grad_norm


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    max_epochs: int = 15
    num_accum: int = 1
    clip_grad: float = 10.0
    seed: int = 10
    output_type: str = "vq0"     # 'feat' | 'vq0'
    num_classes: int = 27
    extra_classes: int = 0
    skip_nonfinite: bool = True

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "TrainConfig":
        t = cfg.get("train", {})
        return TrainConfig(
            max_epochs=t.get("max_epochs", 15),
            num_accum=t.get("num_accum", 1),
            clip_grad=t.get("clip_grad", 10.0),
            seed=cfg.get("seed", 10),
            output_type=cfg.get("eval", {}).get("output_type", "vq0"),
            num_classes=cfg["num_classes"],
            extra_classes=cfg.get("eval", {}).get("extra_classes", 0),
            skip_nonfinite=bool(t.get("skip_nonfinite", True)),
        )


# loss-weight keys in cfg['loss'] -> aux keys the models emit
LOSS_WEIGHT_MAP = {
    "stego_weight": "stego-loss",
    "vq_weight": "vq-loss",
    "recon_weight": "recon-loss",
    "cls_weight": "cls-loss",
    "mse_weight": "mse-loss",
    "jsd_weight": "jsd",
    "info_nce_weight": "info_nce-loss",
    "margin_weight": "margin-loss",
    "club_weight": "club-loss",
    "swav_weight": "swav-loss",
}

_METRIC_AUX_KEYS = ("stego-loss", "vq-loss", "codebook-usage", "codebook-sum")


class Trainer:
    """``Trainer(cfg)`` builds the model of ``cfg`` (a config dict as the
    YAML files hold it) with weights drawn from ``seed`` (``cfg['seed']``
    when None), the probes and the three optimizers; ``model`` takes an
    ``EQUSS`` built by the caller instead.  ``device=None`` means CUDA,
    which must then be present; pass ``device='cpu'`` to run on the CPU.
    ``train_step(batch)`` runs one step and returns its metrics."""

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None,
                 seed: Optional[int] = None, model: Optional[EQUSS] = None):
        self.cfg = cfg
        self.tc = TrainConfig.from_config(cfg)
        self.device = resolve_device(device)
        seed = self.tc.seed if seed is None else seed
        if cfg.get("train", {}).get("supervised") or cfg["model"].get("name") == "sl":
            raise NotImplementedError("supervised training is not ported yet")
        if cfg["model"].get("name", "pqgo") != "pqgo":
            raise NotImplementedError(f"model {cfg['model']['name']} is not ported yet")
        self.model = model if model is not None else EQUSS(
            EQUSSConfig.from_config(cfg), device=self.device, seed=seed)
        if self.model.device != self.device:
            raise ValueError(f"model on {self.model.device}, trainer on {self.device}")
        ev = cfg.get("eval", {})
        self.evaluator = Evaluator(EvaluatorConfig(
            embed_dim=self.model.cfg.hidden_dim,
            num_classes=self.tc.num_classes,
            extra_classes=self.tc.extra_classes,
            alpha=ev.get("cluster_alpha"),
            probe_res=ev.get("probe_res", "feat"),
        ), torch.Generator().manual_seed(seed + 1)).to(self.device)
        self.loss_weights = {aux_key: float(cfg["loss"][wkey])
                             for wkey, aux_key in LOSS_WEIGHT_MAP.items()
                             if float(cfg["loss"].get(wkey, 0.0) or 0.0) > 0.0}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        opt_cfg, sch_cfg = cfg["optimizer"], cfg.get("scheduler", {})
        ipe = cfg.get("train", {}).get("iter_per_epoch", cfg.get("_iter_per_epoch", 100))
        common = dict(iter_per_epoch=max(int(ipe), 1), max_epochs=self.tc.max_epochs,
                      num_accum=self.tc.num_accum)
        self.model_params = [(n, p) for n, p in self.model.named_parameters()
                             if not n.startswith("backbone.")]
        self.probe_params = list(self.evaluator.named_parameters())
        self.tx_model = build_optimizer(self.model_params, opt_cfg["model"],
                                        sch_cfg.get("model"), clip_grad=self.tc.clip_grad,
                                        **common)
        self.tx_cluster = build_optimizer(self.evaluator.cluster_probe.named_parameters(),
                                          opt_cfg["cluster"], sch_cfg.get("cluster"), **common)
        self.tx_linear = build_optimizer(self.evaluator.linear_probe.named_parameters(),
                                         opt_cfg["linear"], sch_cfg.get("linear"), **common)

    # ----------------------------------------------------------- weights
    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a state dict of the model's names, plus the probes' under
        ``probes.`` (``convert.params_from_jax`` with probe_params), in
        place: the optimizers keep their parameters."""
        probes = {k[len("probes."):]: v for k, v in sd.items() if k.startswith("probes.")}
        self.model.load_state_dict({k: v for k, v in sd.items()
                                    if not k.startswith("probes.")})
        self.evaluator.load_state_dict(probes)

    # -------------------------------------------------------------- step
    def _model_loss(self, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
        missing = sorted(k for k in self.loss_weights if k not in aux)
        if missing:
            raise ValueError(
                f"configured loss weights map to aux keys {missing} that the "
                f"model does not emit in training (emitted: {sorted(aux)}); "
                f"fix cfg['loss'] or the model")
        return sum(w * aux[k] for k, w in self.loss_weights.items())

    def _select_out(self, out: Dict[str, Any]) -> torch.Tensor:
        sel = out["z_q"] if self.tc.output_type.startswith("vq") else out["code"]
        return sel.detach()

    def _batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """Host batch (numpy or tensors) -> tensors on the device: images
        normalised, labels int64, the STEGO override keys as given."""
        out: Dict[str, Any] = {}
        for k, v in batch.items():
            if v is None or k not in ("img", "img_pos", "feat", "feat_pos", "label",
                                      "stego_coords1", "stego_coords2", "stego_perms"):
                continue
            t = torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v
            out[k] = t.to(self.device, non_blocking=True)
        for k in ("img", "img_pos"):
            if k in out:
                out[k] = normalize_images(out[k])
        out["label"] = out["label"].long()
        return out

    def forward_backward(self, batch: Mapping[str, Any]):
        """Zero the gradients, run the training forward and the backward
        on ``batch``.  Returns ``(metrics, out)``: the metric tensors and
        the model's training outputs, whose ``pq_state`` is the quantizer
        state this step would set.  Nothing is updated; the gradients are
        left in the parameters' ``.grad``."""
        b = self._batch(batch)
        for tx in (self.tx_model, self.tx_cluster, self.tx_linear):
            tx.zero_grad()
        override = None
        if "stego_coords1" in b:
            override = (b["stego_coords1"], b["stego_coords2"], b["stego_perms"])
        out = self.model(b.get("img"), b.get("img_pos"), feat=b.get("feat"),
                         feat_pos=b.get("feat_pos"), training=True,
                         generator=self.generator, stego_override=override)
        aux = out["aux"]
        model_loss = self._model_loss(aux)
        ev = self.evaluator(self._select_out(out), b["label"])
        total = model_loss + ev["linear_loss"] + ev.get("cluster_loss", 0.0)
        total.backward()
        metrics = {"loss": total, "model-loss": model_loss,
                   "linear-loss": ev["linear_loss"]}
        if "cluster_loss" in ev:
            metrics["cluster-loss"] = ev["cluster_loss"]
        metrics.update({k: aux[k] for k in _METRIC_AUX_KEYS if k in aux})
        metrics["grad-norm"] = global_grad_norm(p for _, p in self.model_params)
        metrics["probe-grad-norm"] = global_grad_norm(p for _, p in self.probe_params)
        return metrics, out

    def train_step(self, batch: Mapping[str, Any]) -> Dict[str, float]:
        """One training step; returns its metrics as floats (``skipped`` is
        1.0 where a non-finite loss or gradient left everything as it
        was)."""
        metrics, out = self.forward_backward(batch)
        names = list(metrics)
        values = torch.stack([metrics[k].detach().float().reshape(())
                              for k in names]).tolist()
        result = dict(zip(names, values))
        ok = all(np.isfinite(result[k]) for k in ("loss", "grad-norm", "probe-grad-norm"))
        result["skipped"] = 0.0 if ok or not self.tc.skip_nonfinite else 1.0
        if result["skipped"] == 0.0:
            self.tx_model.step(metrics["grad-norm"])
            self.tx_cluster.step()
            self.tx_linear.step()
            with torch.no_grad():
                for name, t in out["pq_state"].items():
                    getattr(self.model.pq_state, name).copy_(t)
        return result
