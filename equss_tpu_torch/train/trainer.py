"""The trainer of every registry model: the train step, the valid steps
and the epoch loop.

Counterpart of ``equss_tpu/train/trainer.py`` (``TrainConfig``,
``LOSS_WEIGHT_MAP``, ``Trainer.__init__``, ``_model_loss``,
``_select_out``, ``_trainable``, ``_normalize_batch``,
``_train_step_impl``, ``_valid_step_impl``, ``_valid_crf_step_impl``,
``validate``, ``validate_crf`` and ``fit``).  The model comes from
``models/registry.py::build_model`` (EQUSS for ``pqgo`` and ``vq``,
STEGO for ``stego`` and ``sl``, the probe-only model for ``probe``, the
variants of ``models/variants.py``).  One
step runs the model's training forward, the weighted loss, the probe
losses, one backward, and three optimizers: the model's (its trainable
parameters: head and codebook, none for the probe-only model; the frozen
backbone is never trained), clipped at ``clip_grad``, and the two
probes', unclipped.  The probes see detached features, except in
supervised mode (``train.supervised`` or ``model.name: sl``), where their
cross-entropy trains the head and there is no cluster probe.  A step
whose loss or gradients are not finite changes no parameter, no
optimizer state and no model state (``train.skip_nonfinite``): the
forward returns the model's new state (the quantizer's counts and EMA
codebook, the SwAV queue, the EMA head, the CLUB encoder and its Adam
moments, BatchNorm's running averages) without writing it, and the
trainer copies it into the model's buffers only after that check.  The
step counter advances either way, as the JAX step's does.

Models that consume a photometric view (``consumes_aug``) get
``aug_img`` from ``data.transforms.photometric_apply`` in the step, on
the device, its factors (``photometric_draws``) drawn from the trainer's
generator for the global batch before normalisation; a
batch's own ``aug_img`` takes precedence, ``train.photometric_aug:
false`` turns the view off and a dict gives its keyword arguments.

The train state lives in the trainer: the weights, the optimizers, the
step and ``generator``, which draws the dropout masks and STEGO's
samples.  ``train_state()`` reads it out and ``load_train_state`` puts
one back, which is what ``core/checkpoint.py`` saves and restores.

The valid step runs the eval forward at the batch's resolution and both
probes, and counts each probe's confusion matrix on the device;
``validate`` sums them over a loader and reports the Hungarian-matched
Cluster mIoU / Accuracy and the Linear ones.  ``validate_crf`` does the
same after refining each probe's log-probabilities with the dense CRF
(``ops/crf.py``), the final evaluation of a run with ``eval.final_crf``.
``fit`` is the epoch loop: print-interval logging, the non-finite
streak, periodic validation, the best result keyed on ``Cluster_mIoU``
with a checkpoint on each new best, and an exact resume from the middle
of an epoch.  A model whose state is initialised from data
(``needs_data_init``: a ``kmeans`` or ``rand`` codebook, EMAModel's memory
bank) gets its ``data_init`` on the first batch of a fresh ``fit``, before
the first step; a resumed run and ``train_step`` alone do not call it.
Under ``torch.profiler`` a step's layers are spans (``core/trace.py``):
``equss.batch`` (the copy in), the model's own, ``equss.probes``,
``equss.backward``, ``equss.read`` (the metrics' host read, which is the
non-finite check's sync) and ``equss.optimizer``.

With ``train.num_accum`` k > 1 each step is a micro-step of optax's
``MultiSteps``: the three optimizers average k micro-steps' gradients and
update on the k-th (``train/optim.py``), while the model state commits
after every finite micro-step, as in JAX; a skipped micro-step leaves the
gradient mean and the micro-step count as they were.  ``validate`` and
``validate_crf`` with ``visualize_to`` write the prediction and codeword
PNGs (``utils/visualize.py``).

On several processes (``torch.distributed`` initialised,
``parallel/mesh.py``) the ranks run one global program, as the JAX
trainer runs one over its data mesh: each rank holds its own rows of
every batch and the same weights (rank 0's, broadcast at construction),
and the steps run inside ``mesh.global_program()``, where the modules
reduce what couples rows (the quantizer's counts, STEGO's negatives and
means, the probes' pixel count, the random draws made for the global
batch, the photometric view's factors among them, and each variant
family's couplings: ``models/variants.py``).  Each rank backpropagates
its share of the global mean (its loss over the world size), the ranks
sum their gradients in one
all-reduce of the flattened gradient before the norm, the clip and the
non-finite check, and the metrics are the ranks' mean: every rank takes
the same skip decision and the same optimizer steps, and holds the same
parameters bit for bit.  ``validate`` sums the confusion matrices over
the ranks before the Hungarian matching.  ``data_init`` runs on every
rank on the gathered images of the global batch and keeps rank 0's
values.  Every registered family runs so.

On a (data, model) grid (``Trainer(cfg, mesh=parallel.mesh.make_mesh_2d(
data, model))``, as the JAX ``Trainer(mesh=...)``) the program's ranks
are this rank's data group: each data rank feeds its rows, the model
ranks of a data group the same rows, and the gradient bucket, the
metrics and the validation sums are summed over the data group.  After
``mesh.shard_quantizer(grid, trainer.model)`` and / or
``mesh.shard_backbone(grid, trainer.model)`` the steps run on the
shards: Adam updates each rank's codebook shard, and the gradient norm
(for the clip and the non-finite skip) counts each sharded parameter's
squares once over the model group and each whole one once.
``state_dict`` and ``train_state`` gather the shards into whole tensors,
and ``load_state_dict`` and ``load_train_state`` take this rank's parts
of whole ones, so a checkpoint written on a grid loads into one process
and the other way round.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from equss_tpu_torch.core import trace
from equss_tpu_torch.core.logging import MetricsLogger, count_params
from equss_tpu_torch.data.transforms import (normalize_images, photometric_apply,
                                             photometric_draws)
from equss_tpu_torch.device import DeviceLike, resolve_device
from equss_tpu_torch.eval.metrics import UnSegMetrics, confusion_update
from equss_tpu_torch.eval.probes import Evaluator, EvaluatorConfig
from equss_tpu_torch.models.registry import build_model
from equss_tpu_torch.ops.crf import CRFConfig, batched_crf
from equss_tpu_torch.parallel import mesh
from equss_tpu_torch.train.optim import build_optimizer, global_grad_norm

_MESH = mesh


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    max_epochs: int = 15
    num_accum: int = 1
    clip_grad: float = 10.0
    print_interval_iters: int = 25
    valid_interval_iters: int = 75
    seed: int = 10
    output_type: str = "vq0"     # 'feat' | 'vq0'
    num_classes: int = 27
    extra_classes: int = 0
    # skip the update of a step whose loss or gradients are not finite;
    # fit raises after ``nonfinite_patience`` consecutive print-interval
    # samples of skipped steps
    skip_nonfinite: bool = True
    nonfinite_patience: int = 3

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "TrainConfig":
        t = cfg.get("train", {})
        return TrainConfig(
            max_epochs=t.get("max_epochs", 15),
            num_accum=t.get("num_accum", 1),
            clip_grad=t.get("clip_grad", 10.0),
            print_interval_iters=t.get("print_interval_iters", 25),
            valid_interval_iters=t.get("valid_interval_iters", 75),
            seed=cfg.get("seed", 10),
            output_type=cfg.get("eval", {}).get("output_type", "vq0"),
            num_classes=cfg["num_classes"],
            extra_classes=cfg.get("eval", {}).get("extra_classes", 0),
            skip_nonfinite=bool(t.get("skip_nonfinite", True)),
            nonfinite_patience=int(t.get("nonfinite_patience", 3)),
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

_METRIC_AUX_KEYS = ("stego-loss", "vq-loss", "codebook-usage", "codebook-sum", "jsd",
                    "entropy", "recon-loss", "info_nce-loss", "margin-loss", "swav-loss",
                    "club-loss", "club-enc-loss", "club-enc-loss-first", "mse-loss",
                    "cls-loss", "contra-loss-pos", "contra-loss-neg")


_PER_VQ = re.compile(r"vq\d+-(loss|usage)")


class Trainer:
    """``Trainer(cfg)`` builds the model of ``cfg`` (a config dict as the
    YAML files hold it; ``build_model``) with weights drawn from ``seed``
    (``cfg['seed']`` when None), the probes and the three optimizers;
    ``model`` takes a model built by the caller instead.  ``device=None`` means CUDA,
    which must then be present; pass ``device='cpu'`` to run on the CPU.
    ``mesh``: the process's (data, model) grid (``make_mesh_2d``), over
    whose data group the steps run (the module docstring).
    ``train_step(batch)`` runs one step and returns its metrics,
    ``valid_step(batch)`` one eval step and ``validate(batches)`` the
    metrics over a loader (``validate_crf`` with the CRF); ``fit`` runs
    the epoch loop.  The train state (model, probes, optimizers, step,
    generator) lives in the trainer itself; ``state_dict()`` reads the
    weights out, ``train_state()`` all of it."""

    def __init__(self, cfg: Dict[str, Any], *, device: DeviceLike = None,
                 seed: Optional[int] = None, model: Optional[nn.Module] = None,
                 mesh: Optional["_MESH.Grid"] = None):
        grid, mesh = mesh, _MESH
        if grid is not None and grid is not mesh.grid():
            raise ValueError("Trainer(mesh=...) takes this process's grid: the one "
                             "make_mesh_2d returned")
        # in a process group the steps take the distributed path, one
        # rank included; on a grid over the data group
        self.grid = grid
        self.world = grid.data if grid is not None else mesh.world()
        self.distributed = mesh.in_group()
        self.cfg = cfg
        self.tc = TrainConfig.from_config(cfg)
        self.device = resolve_device(device)
        seed = self.tc.seed if seed is None else seed
        self.model = model if model is not None else build_model(
            cfg, device=self.device, seed=seed)
        if self.model.device != self.device:
            raise ValueError(f"model on {self.model.device}, trainer on {self.device}")
        # supervised mode: the probe's cross-entropy trains the head, and
        # there is no cluster probe
        self.supervised = bool(cfg.get("train", {}).get("supervised", False)
                               or cfg["model"].get("name") == "sl")
        ev = cfg.get("eval", {})
        self.evaluator = Evaluator(EvaluatorConfig(
            embed_dim=self.model.output_dim(self.tc.output_type),
            num_classes=self.tc.num_classes,
            extra_classes=self.tc.extra_classes,
            alpha=ev.get("cluster_alpha"),
            probe_res=ev.get("probe_res", "feat"),
            with_cluster=not self.supervised,
        ), torch.Generator().manual_seed(seed + 1)).to(self.device)
        self.loss_weights = {aux_key: float(cfg["loss"][wkey])
                             for wkey, aux_key in LOSS_WEIGHT_MAP.items()
                             if float(cfg["loss"].get(wkey, 0.0) or 0.0) > 0.0}
        # the nested weights of the contrast variants (vae, contra)
        contra = cfg["loss"].get("contra_weight", {}) or {}
        for part in ("pos", "neg"):
            if float(contra.get(part, 0.0) or 0.0) > 0.0:
                self.loss_weights[f"contra-loss-{part}"] = float(contra[part])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        aug_cfg = cfg.get("train", {}).get("photometric_aug", True)
        self.apply_aug = bool(getattr(self.model, "consumes_aug", False)) and aug_cfg is not False
        self.aug_kwargs = dict(aug_cfg) if isinstance(aug_cfg, dict) else {}

        opt_cfg, sch_cfg = cfg["optimizer"], cfg.get("scheduler", {})
        ipe = cfg.get("train", {}).get("iter_per_epoch", cfg.get("_iter_per_epoch", 100))
        # one value for the schedules and fit's resume epoch
        self.iter_per_epoch = max(int(ipe), 1)
        self.step = 0
        common = dict(iter_per_epoch=self.iter_per_epoch, max_epochs=self.tc.max_epochs,
                      num_accum=self.tc.num_accum)
        self.model_params = [(n, p) for n, p in self.model.named_parameters()
                             if not n.startswith("backbone.")]
        self.probe_params = list(self.evaluator.named_parameters())
        self.tx_model = build_optimizer(self.model_params, opt_cfg["model"],
                                        sch_cfg.get("model"), clip_grad=self.tc.clip_grad,
                                        **common)
        cluster = self.evaluator.cluster_probe
        self.tx_cluster = build_optimizer(cluster.named_parameters() if cluster else [],
                                          opt_cfg["cluster"], sch_cfg.get("cluster"), **common)
        self.tx_linear = build_optimizer(self.evaluator.linear_probe.named_parameters(),
                                         opt_cfg["linear"], sch_cfg.get("linear"), **common)
        if self.world > 1:
            mesh.replicate(self.model)
            mesh.replicate(self.evaluator)

    # ----------------------------------------------------------- weights
    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a state dict of the model's names, plus the probes' under
        ``probes.`` (``convert.params_from_jax`` with probe_params), in
        place: the optimizers keep their parameters.  A sharded model takes
        its parts of whole tensors."""
        probes = {k[len("probes."):]: v for k, v in sd.items() if k.startswith("probes.")}
        self.model.load_state_dict(self._model_part({k: v for k, v in sd.items()
                                                     if not k.startswith("probes.")}))
        self.evaluator.load_state_dict(probes)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict plus the probes' under ``probes.``: what
        ``load_state_dict`` takes.  A sharded model's tensors are gathered
        whole."""
        return {**self._model_whole(self.model.state_dict()),
                **{f"probes.{k}": v for k, v in self.evaluator.state_dict().items()}}

    def _model_whole(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A model state dict with the shards of a sharded model gathered."""
        layout = mesh.sharded_layout(self.model)
        return mesh.gather_sharded(sd, layout) if layout else sd

    def _model_part(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A model state dict with this rank's parts of a sharded model's
        whole tensors."""
        layout = mesh.sharded_layout(self.model)
        if not layout:
            return dict(sd)
        return mesh.take_sharded(dict(sd), layout, self.model.state_dict())

    def _opt_sharded(self, osd: Dict[str, Any], whole: bool) -> Dict[str, Any]:
        """The model optimizer's state (``Optimizer.state_dict``) with each
        sharded parameter's moments and gradient mean gathered whole
        (``whole``) or cut to this rank's part."""
        layout = mesh.sharded_layout(self.model)
        if not layout:
            return osd
        params = dict(self.model.named_parameters())

        def conv(name, t):
            if name not in layout or not torch.is_tensor(t) or t.dim() == 0:
                return t
            if whole:
                return mesh.gather_sharded({name: t}, layout)[name]
            return mesh.take_sharded({name: t}, layout, {name: params[name]})[name]

        out = dict(osd)
        out["state"] = {n: {k: conv(n, v) for k, v in st.items()}
                        for n, st in osd["state"].items()}
        if "acc" in osd:
            out["acc"] = {n: conv(n, v) for n, v in osd["acc"].items()}
        return out

    def _optimizers(self):
        return {"model": self.tx_model, "cluster": self.tx_cluster, "linear": self.tx_linear}

    def train_state(self) -> Dict[str, Any]:
        """Everything a resumed run needs, as the JAX train state holds it:
        ``model`` (the model's state dict: parameters and the model's
        state buffers), ``probes``, ``opt`` (each optimizer's
        ``state_dict``), ``step``, and ``generator`` with
        ``generator_device`` (its state and device type).  The tensors
        are the live ones: copy before training on
        (``CheckpointManager.save`` does)."""
        opt = {k: tx.state_dict() for k, tx in self._optimizers().items()}
        opt["model"] = self._opt_sharded(opt["model"], whole=True)
        return {"model": self._model_whole(self.model.state_dict()),
                "probes": self.evaluator.state_dict(),
                "opt": opt,
                "step": self.step,
                "generator": self.generator.get_state(),
                "generator_device": self.device.type}

    def load_train_state(self, state: Mapping[str, Any], *,
                         resume_training: bool = True) -> None:
        """Load a ``train_state()`` (from any device) into this trainer:
        weights, optimizers and step always; with ``resume_training``
        also the generator, so the run continues with the draws it would
        have made.  A generator's state restores only into a generator of
        its own device type, so continuing training from another device
        type's checkpoint raises; an eval-only restore
        (``resume_training=False``) keeps this trainer's generator.  A
        state without a generator (``convert.train_state_from_jax``)
        keeps it too."""
        saved = state.get("generator_device")
        if resume_training and saved is not None and saved != self.device.type:
            raise ValueError(
                f"cannot continue training on {self.device.type} from a checkpoint "
                f"whose generator is a {saved} generator; restore it for "
                f"evaluation only (resume.mode: eval) or train on {saved}")
        self.model.load_state_dict(self._model_part(state["model"]))
        self.evaluator.load_state_dict(state["probes"])
        for name, tx in self._optimizers().items():
            osd = state["opt"][name]
            tx.load_state_dict(self._opt_sharded(osd, whole=False) if name == "model" else osd)
        self.step = int(state["step"])
        if resume_training and state.get("generator") is not None:
            self.generator.set_state(state["generator"])

    # -------------------------------------------------------------- step
    def _model_loss(self, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
        missing = sorted(k for k in self.loss_weights if k not in aux)
        if missing:
            raise ValueError(
                f"configured loss weights map to aux keys {missing} that the "
                f"model does not emit in training (emitted: {sorted(aux)}); "
                f"fix cfg['loss'] or the model")
        loss = torch.zeros((), device=self.device)
        for k, w in self.loss_weights.items():
            loss = loss + w * aux[k]
        return loss

    def _select_out(self, out: Dict[str, Any]) -> torch.Tensor:
        """What the probes see: ``z_q`` for ``eval.output_type: vq*``,
        else ``code``; detached unless supervised."""
        if self.tc.output_type.startswith("vq"):
            if "z_q" not in out:
                raise ValueError(f"model {type(self.model).__name__} has no quantized "
                                 f"output; set eval.output_type: feat")
            sel = out["z_q"]
        else:
            sel = out["code"]
        return sel if self.supervised else sel.detach()

    _TRAIN_KEYS = ("img", "img_pos", "aug_img", "feat", "feat_pos", "label",
                   "stego_coords1", "stego_coords2", "stego_perms", "info_nce_idx",
                   "kmeans_first", "kmeans_gumbel")
    # what only a model with a photometric view (``consumes_aug``) reads:
    # the view, its InfoNCE negatives and NewVQ's stage-1 k-means draws
    _VIEW_KEYS = ("aug_img", "info_nce_idx", "kmeans_first", "kmeans_gumbel")

    def _batch(self, batch: Mapping[str, Any], keys: Iterable[str] = _TRAIN_KEYS,
               aug: bool = False) -> Dict[str, Any]:
        """Host batch (numpy or tensors) -> the tensors of ``keys`` on the
        device: with ``aug`` and no ``aug_img`` in the batch, the
        photometric view of the [0, 1] images; images normalised, labels
        int64, the STEGO and InfoNCE override keys as given."""
        out = mesh.shard_batch({k: v for k, v in batch.items()
                                if v is not None and k in keys}, self.device)
        if aug and "aug_img" not in out:
            img = out["img"]
            img01 = img.float() / 255.0 if img.dtype == torch.uint8 else img
            # each image's factors: this rank's rows of the global batch's
            factors = {k: v for k, v in self.aug_kwargs.items() if k != "blur_kernel"}
            draws = photometric_draws(self.generator, img.shape[0] * mesh.program_world(),
                                      img.device, **factors)
            draws = {k: mesh.local_rows(v) for k, v in draws.items()}
            out["aug_img"] = photometric_apply(img01, draws,
                                               self.aug_kwargs.get("blur_kernel", 3))
        for k in ("img", "img_pos", "aug_img"):
            if k in out:
                out[k] = normalize_images(out[k])
        out["label"] = out["label"].long()
        return out

    def forward_backward(self, batch: Mapping[str, Any]):
        """Zero the gradients, run the training forward and the backward
        on ``batch``.  Returns ``(metrics, out)``: the metric tensors and
        the model's training outputs, whose ``state`` (buffer name -> new
        value) is the model state this step would set.  Nothing is
        updated; the gradients are left in the parameters' ``.grad``."""
        with mesh.global_program():
            return self._forward_backward(batch)

    def _forward_backward(self, batch: Mapping[str, Any]):
        consumes = getattr(self.model, "consumes_aug", False)
        # the model's own random draws that a batch may fix (``draw_keys``)
        draws = tuple(getattr(self.model, "draw_keys", ()))
        keys = (self._TRAIN_KEYS if consumes else tuple(
            k for k in self._TRAIN_KEYS if k not in self._VIEW_KEYS)) + draws
        with trace.span("equss.batch"):
            b = self._batch(batch, keys, aug=self.apply_aug)
        for tx in (self.tx_model, self.tx_cluster, self.tx_linear):
            tx.zero_grad()
        override = None
        if "stego_coords1" in b:
            override = (b["stego_coords1"], b["stego_coords2"], b["stego_perms"])
        view = {k: b.get(k) for k in self._VIEW_KEYS} if consumes else {}
        view.update({k: b[k] for k in draws if k in b})
        out = self.model(b.get("img"), b.get("img_pos"), feat=b.get("feat"),
                         feat_pos=b.get("feat_pos"), training=True,
                         generator=self.generator, stego_override=override, **view)
        aux = out["aux"]
        model_loss = self._model_loss(aux)
        with trace.span("equss.probes"):
            ev = self.evaluator(self._select_out(out), b["label"])
        total = model_loss + ev["linear_loss"] + ev.get("cluster_loss", 0.0)
        with trace.span("equss.backward"):
            # each rank's share of the global mean; the ranks' gradients sum
            (total / self.world if self.distributed else total).backward()
            self._sum_gradients()
        metrics = {"loss": total, "model-loss": model_loss,
                   "linear-loss": ev["linear_loss"]}
        if "cluster_loss" in ev:
            metrics["cluster-loss"] = ev["cluster_loss"]
        metrics.update({k: aux[k] for k in _METRIC_AUX_KEYS if k in aux})
        # UnSeg's per-quantizer terms
        metrics.update({k: v for k, v in aux.items() if _PER_VQ.fullmatch(k)})
        # without trainable model parameters (the probe-only model) the
        # norm is a CPU zero: onto the device with the other metrics
        metrics["grad-norm"] = global_grad_norm(
            p for _, p in self.model_params).to(self.device)
        metrics["probe-grad-norm"] = global_grad_norm(p for _, p in self.probe_params)
        if self.distributed:
            names = list(metrics)
            means = mesh.mean_over_ranks(torch.stack(
                [metrics[k].detach().float().reshape(()) for k in names]))
            metrics = dict(zip(names, means.unbind(0)))
        return metrics, out

    def _sum_gradients(self) -> None:
        """The ranks' gradients summed in one all-reduce of the flattened
        gradient (model and probes); a parameter without a gradient keeps
        none, as on one process."""
        if not self.distributed:
            return
        params = [p for _, p in (*self.model_params, *self.probe_params) if p.grad is not None]
        flat = mesh.all_reduce_sum(torch.cat([p.grad.reshape(-1) for p in params]))
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def train_step(self, batch: Mapping[str, Any]) -> Dict[str, float]:
        """One training step; returns its metrics as floats (``skipped`` is
        1.0 where a non-finite loss or gradient left everything as it
        was)."""
        metrics, out = self.forward_backward(batch)
        names = list(metrics)
        with trace.span("equss.read"):
            values = torch.stack([metrics[k].detach().float().reshape(())
                                  for k in names]).tolist()
        result = dict(zip(names, values))
        ok = all(np.isfinite(result[k]) for k in ("loss", "grad-norm", "probe-grad-norm"))
        result["skipped"] = 0.0 if ok or not self.tc.skip_nonfinite else 1.0
        self.step += 1
        if result["skipped"] == 0.0:
            with trace.span("equss.optimizer"):
                self.tx_model.step(metrics["grad-norm"])
                self.tx_cluster.step()
                self.tx_linear.step()
                buffers = dict(self.model.named_buffers())
                with torch.no_grad():
                    for name, t in out.get("state", {}).items():
                        buffers[name].copy_(t)
        return result

    def data_init(self, batch: Mapping[str, Any]) -> None:
        """The model's data-dependent init (``model.data_init``) on the
        images of a host batch, its draws from the trainer's generator;
        the new values are copied into the model's parameters and
        buffers.  On several processes every rank runs it on the gathered
        images of the global batch with the same draws, as one process
        does, and takes rank 0's values."""
        b = self._batch(batch, keys=("img", "label"))
        with torch.no_grad():
            with mesh.global_program():
                img = mesh.gather_rows(b["img"])
            new = self.model.data_init(img, self.generator)
            tensors = self.model.state_dict(keep_vars=True)
            with mesh.global_program():
                new = {name: mesh.broadcast_(t.contiguous()) for name, t in new.items()}
            # a sharded model keeps its parts
            for name, t in self._model_part(new).items():
                tensors[name].data.copy_(t)

    # -------------------------------------------------------- validation
    def valid_step(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """One eval step on a host batch (``img``, ``label``) at its own
        resolution: the inference forward and both probes, without
        autograd.  Returns device tensors: ``linear_conf`` (num_classes,
        num_classes) and, with the cluster probe, ``cluster_conf``
        (num_classes + extra_classes, num_classes), both int64 with rows
        = predictions; ``linear_loss`` / ``cluster_loss``;
        ``linear_preds`` / ``cluster_preds`` (b, H, W) int32; and
        ``pq_indices`` (b, gh, gw, M).  On several processes the batch is
        this rank's rows and the losses its share of the global batch's
        (``validate`` sums the matrices over the ranks)."""
        b = self._batch(batch, keys=("img", "label"))
        with torch.no_grad(), mesh.global_program():
            out = self.model(b["img"], training=False)
            ev = self.evaluator(self._select_out(out), b["label"])
        n, e = self.tc.num_classes, self.tc.extra_classes
        res = {"linear_conf": confusion_update(ev["linear_preds"], b["label"], n, 0),
               "linear_loss": ev["linear_loss"],
               "linear_preds": ev["linear_preds"]}
        if "cluster_preds" in ev:
            res["cluster_conf"] = confusion_update(ev["cluster_preds"], b["label"], n, e)
            res["cluster_loss"] = ev["cluster_loss"]
            res["cluster_preds"] = ev["cluster_preds"]
        if "indices" in out:
            res["pq_indices"] = out["indices"]
        return res

    def validate(self, val_iter: Iterable[Mapping[str, Any]], *,
                 visualize_to: Optional[str] = None) -> Dict[str, float]:
        """``valid_step`` over every batch of ``val_iter``: Linear_mIoU,
        Linear_Accuracy, Cluster_mIoU and Cluster_Accuracy (Hungarian
        matched) in percent from the summed confusion matrices, and the
        mean probe losses ``val_linear_loss`` / ``val_cluster_loss``.
        Without a cluster probe the Cluster keys repeat the Linear ones.
        The sums stay on the device until the end.  ``visualize_to`` writes
        the PNGs of ``_visualize`` there (with a cluster probe): each
        batch's predictions, labels and codeword indices are copied to the
        host as it is saved."""
        n, e = self.tc.num_classes, self.tc.extra_classes
        cluster_m = UnSegMetrics(n, e, compute_hungarian=True)
        linear_m = UnSegMetrics(n, 0, compute_hungarian=False)
        sums: Dict[str, Any] = {}
        batches = 0
        has_cluster = True
        saved: Dict[str, list] = {}
        for batch in val_iter:
            res = self.valid_step(batch)
            has_cluster = "cluster_conf" in res
            for k in ("linear_conf", "cluster_conf", "linear_loss", "cluster_loss"):
                if k in res:
                    sums[k] = sums.get(k, 0) + res[k]
            if visualize_to is not None and has_cluster:
                self._save_for_visualize(saved, res, batch)
            batches += 1
        self._sum_over_ranks(sums)
        sums = {k: v.cpu() for k, v in sums.items()}
        per_loss = max(batches, 1) * self.world
        if "linear_conf" in sums:
            linear_m.update_confusion(sums["linear_conf"])
        linear = linear_m.compute()
        out = {
            "Linear_mIoU": linear["iou"],
            "Linear_Accuracy": linear["accuracy"],
            # a rank's loss is its share of the global batch's times the
            # world size, and the sums run over the ranks
            "val_linear_loss": float(sums.get("linear_loss", 0.0)) / per_loss,
            "val_cluster_loss": float(sums.get("cluster_loss", 0.0)) / per_loss,
        }
        if has_cluster:
            if "cluster_conf" in sums:
                cluster_m.update_confusion(sums["cluster_conf"])
            cluster = cluster_m.compute()
            out["Cluster_mIoU"] = cluster["iou"]
            out["Cluster_Accuracy"] = cluster["accuracy"]
            if saved:
                self._visualize(visualize_to, saved, cluster_m)
        else:
            # keeps fit's best-result key defined without a cluster probe
            out["Cluster_mIoU"] = linear["iou"]
            out["Cluster_Accuracy"] = linear["accuracy"]
        return out

    # ---------------------------------------------------------- CRF eval
    def valid_crf_step(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The final evaluation's step with CRF refinement: the inference
        forward, both probes' label-resolution log-probabilities, the
        dense CRF (``CRFConfig(**cfg['eval']['crf'])``) on each image of
        each, and the argmax.  Returns ``linear_conf`` and
        ``linear_preds`` and, with the cluster probe, ``cluster_conf`` and
        ``cluster_preds``, on the device, as ``valid_step`` does."""
        b = self._batch(batch, keys=("img", "label"))
        crf_cfg = CRFConfig(**(self.cfg.get("eval", {}).get("crf", {}) or {}))
        n, e = self.tc.num_classes, self.tc.extra_classes
        with torch.no_grad(), mesh.global_program():
            out = self.model(b["img"], training=False)
            ev = self.evaluator(self._select_out(out), b["label"], want_log_probs=True)
            res = {}
            for probe, extra in (("linear", 0), ("cluster", e)):
                if f"{probe}_log_probs" not in ev:
                    continue                    # supervised: no cluster probe
                preds = batched_crf(b["img"], ev[f"{probe}_log_probs"], crf_cfg
                                    ).argmax(-1).to(torch.int32)
                res[f"{probe}_conf"] = confusion_update(preds, b["label"], n, extra)
                res[f"{probe}_preds"] = preds
        return res

    def validate_crf(self, val_iter: Iterable[Mapping[str, Any]], *,
                     visualize_to: Optional[str] = None) -> Dict[str, float]:
        """``valid_crf_step`` over every batch of ``val_iter``:
        Cluster_mIoU / Cluster_Accuracy (Hungarian matched) and
        Linear_mIoU / Linear_Accuracy in percent from the summed confusion
        matrices, which stay on the device until the end.  Without a
        cluster probe the Cluster keys repeat the Linear ones, as in
        ``validate`` (the JAX package's CRF step has no such case: it
        reads the cluster probe unconditionally).  ``visualize_to`` writes
        the refined predictions' PNGs there, as ``validate`` does."""
        sums: Dict[str, torch.Tensor] = {}
        saved: Dict[str, list] = {}
        for batch in val_iter:
            res = self.valid_crf_step(batch)
            for k in ("cluster_conf", "linear_conf"):
                if k in res:
                    sums[k] = sums[k] + res[k] if k in sums else res[k]
            if visualize_to is not None and "cluster_preds" in res:
                self._save_for_visualize(saved, res, batch)
        self._sum_over_ranks(sums)
        n, e = self.tc.num_classes, self.tc.extra_classes
        linear_m = UnSegMetrics(n, 0, compute_hungarian=False)
        if "linear_conf" in sums:
            linear_m.update_confusion(sums["linear_conf"].cpu())
        linear = linear_m.compute()
        if self.evaluator.cluster_probe is not None:
            cluster_m = UnSegMetrics(n, e, compute_hungarian=True)
            if "cluster_conf" in sums:
                cluster_m.update_confusion(sums["cluster_conf"].cpu())
            cluster = cluster_m.compute()
            if saved:
                self._visualize(visualize_to, saved, cluster_m)
        else:
            cluster = linear
        return {"Cluster_mIoU": cluster["iou"], "Cluster_Accuracy": cluster["accuracy"],
                "Linear_mIoU": linear["iou"], "Linear_Accuracy": linear["accuracy"]}

    def _save_for_visualize(self, saved: Dict[str, list], res: Dict[str, torch.Tensor],
                            batch: Mapping[str, Any]) -> None:
        """A valid step's predictions, codeword indices (where the model
        quantizes) and the batch's labels, the global batch's rows
        gathered over the ranks, copied to the host into ``saved``."""
        parts = {k: res[k] for k in ("linear_preds", "cluster_preds", "pq_indices") if k in res}
        parts["label"] = torch.as_tensor(batch["label"]).to(self.device)
        with mesh.global_program():
            for k, v in parts.items():
                saved.setdefault(k, []).append(mesh.gather_rows(v).cpu())

    def _visualize(self, out_dir: str, saved: Dict[str, list], cluster_m: UnSegMetrics) -> None:
        """The PNG dumps (``utils/visualize.py``), written by rank 0: each
        image's linear, cluster (remapped by ``cluster_m``'s Hungarian
        assignment) and label maps in the colormap of
        ``dataset.val.dataset_name``, and each subspace's codeword map
        (``eval.visualize_pq_subspaces``, default all) upsampled by the
        patch size."""
        from equss_tpu_torch.utils.visualize import pq_visualization, visualization

        if mesh.rank() != 0:
            return
        data = {k: torch.cat(v) for k, v in saved.items()}
        name = self.cfg.get("dataset", {}).get("val", {}).get("dataset_name", "cocostuff27")
        visualization(out_dir, name, data, cluster_m)
        if "pq_indices" in data:
            pq_visualization(out_dir, data["pq_indices"],
                             subspaces=self.cfg.get("eval", {}).get("visualize_pq_subspaces"),
                             upsample=self.model.vit_cfg.patch_size)

    def _sum_over_ranks(self, sums: Dict[str, Any]) -> None:
        """Each of a valid loop's sums (device tensors) summed over the
        ranks in place."""
        with mesh.global_program():
            for v in sums.values():
                mesh.all_reduce_sum(v)

    # -------------------------------------------------------------- fit
    def fit(self, train_batches: Callable[[int], Iterable[Mapping[str, Any]]],
            val_batches: Callable[[], Iterable[Mapping[str, Any]]], *,
            logger: Optional[MetricsLogger] = None, checkpointer=None,
            img_hw: Tuple[int, int] = (224, 224),
            state: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        """The epoch loop.  ``train_batches(epoch)`` and ``val_batches()``
        give host batches.  Every ``print_interval_iters`` steps the
        step's metrics and ``iter_time`` (seconds per step since the last
        log) go to ``logger``; a run of ``nonfinite_patience`` such
        samples whose step was skipped as non-finite raises, naming the
        last checkpoint saved.  ``validate`` runs every
        ``valid_interval_iters`` steps and at each epoch's end, and its
        metrics are logged; the best by ``Cluster_mIoU`` is kept with its
        ``epoch`` and ``iter``, and with a ``checkpointer``
        (``core.checkpoint.CheckpointManager``) each new best saves
        ``train_state()`` at its step with ``metadata={"best": best}``.

        Without ``state`` the run is fresh: from the trainer's current
        weights and optimizers, with ``self.step`` reset to 0, so a
        checkpoint's step is its place in this run (the optimizers' counts
        carry any earlier ``train_step``), and a model that
        ``needs_data_init`` takes its ``data_init`` on the first batch.
        ``state`` (a ``train_state()``, as a checkpoint restores it)
        resumes: it is loaded, and the run
        continues at its step, in epoch ``step // iter_per_epoch``, after
        skipping the epoch's first ``step % iter_per_epoch`` batches; an
        epoch's batches are a function of the epoch alone, so no batch is
        trained twice.  ``img_hw`` is the JAX signature's (its state is
        built at that size); the port's weights do not depend on it.

        Returns ``{"state": ..., "best": best}``: a copy of
        ``self.state_dict()`` after the last step, which a later load
        into the trainer (the CLI's reload of the best checkpoint) leaves
        as it is; the trainer holds the rest of the train state."""
        logger = logger or MetricsLogger()
        tc = self.tc
        if state is not None:
            self.load_train_state(state)
        else:
            self.step = 0
        logger.banner(f"params: {count_params(self.model)} (head+pq trainable), "
                      f"probes: {count_params(self.evaluator)}")
        best: Dict[str, Any] = {"Cluster_mIoU": -1.0}

        def validate_and_keep_best(epoch: int, it: int) -> None:
            nonlocal best
            val = self.validate(val_batches())
            logger.log(val, step=it)
            if val["Cluster_mIoU"] > best["Cluster_mIoU"]:
                best = dict(val, epoch=epoch, iter=it)
                if checkpointer is not None:
                    checkpointer.save(it, self.train_state(), metadata={"best": best})

        it = self.step
        start_epoch, skip_batches = divmod(it, self.iter_per_epoch)
        pending_data_init = state is None and bool(getattr(self.model, "needs_data_init",
                                                           False))
        nonfinite_streak = 0
        for epoch in range(start_epoch, tc.max_epochs):
            t0 = time.time()
            epoch_iter = iter(train_batches(epoch))
            if epoch == start_epoch and skip_batches:
                epoch_iter = itertools.islice(epoch_iter, skip_batches, None)
            for batch in epoch_iter:
                if pending_data_init:
                    self.data_init(batch)
                    pending_data_init = False
                metrics = self.train_step(batch)
                it += 1
                if it % tc.print_interval_iters == 0:
                    metrics["iter_time"] = (time.time() - t0) / tc.print_interval_iters
                    t0 = time.time()
                    logger.log(metrics, step=it)
                    if metrics["skipped"] >= 1.0:
                        nonfinite_streak += 1
                        if nonfinite_streak >= tc.nonfinite_patience:
                            saved = (f"; last saved checkpoint: iter {best['iter']}"
                                     if checkpointer is not None and "iter" in best else "")
                            raise RuntimeError(
                                f"training diverged: non-finite loss/grads for "
                                f"{nonfinite_streak} consecutive sampled steps (iter {it})"
                                f"{saved}")
                    else:
                        nonfinite_streak = 0
                if it % tc.valid_interval_iters == 0:
                    validate_and_keep_best(epoch, it)
            validate_and_keep_best(epoch, it)          # end of epoch
        return {"state": {k: v.detach().clone() for k, v in self.state_dict().items()},
                "best": best}
