"""Serving: freeze a trained model and its probes into a standalone
``torch.export`` artifact.

Counterpart of ``equss_tpu/serve.py``.  ``build_predict_fn`` closes the
trainer's model (any registry model) and evaluator into a ``Predictor``
module;
``export_predictor`` exports it with ``torch.export`` (the weights ship
inside the artifact), ``save_predictor`` writes it (``model.pt2`` by
convention) and ``load_predictor`` reads it back into a callable that
needs none of the model-building code: only the kernels' custom-op
registrations (``equss_tpu_torch.ops``), so that the graph's
``equss::attention_qkv`` and ``equss::pq_assign`` calls launch the
kernels on CUDA (and their plain versions on the CPU).

The signature is the JAX package's:

    img (b, H, W, 3) float32  ->  {"cluster_preds": (b, H, W) int32,
                                   "linear_preds":  (b, H, W) int32}

with predictions at input resolution (the probes run against an all
ignore label plane of the input's size).  ``normalize=True`` (default)
folds the ImageNet mean and std into the graph, so the artifact takes raw
[0, 1] RGB; ``load_predictor``'s callable also takes uint8 (divided by
255 first).

An artifact is traced on the trainer's device and lists the devices it
serves (``platforms``, default that device; written beside the program
with ``torch.export.save``'s ``extra_files``), as JAX's multi-platform
artifact does: ``load_predictor(path, device)`` moves the program to any
listed device (``torch.export.passes.move_to_device_pass``), where the
``equss::`` ops dispatch to that device's implementation (the kernels on
CUDA, their plain versions on the CPU), and raises for a device the
artifact does not list.  Its batch is symbolic under ``symbolic_batch="auto"``
(pinned at ``batch_size`` if the symbolic export fails, with the reason
printed) and pinned under ``"off"``.  On CUDA the quantizer's ``auto``
route always takes the kernel, so a symbolic artifact keeps it; on the
CPU a symbolic trace takes the plain route, as the JAX package's does.

``build_sharded_predict_fn`` serves a request's batch split over several
devices (``parallel.mesh.make_mesh``): one replica of the live predictor
per device, the batch split evenly, every replica launched before any
result is read, the predictions concatenated in order.  The forward has
no cross-image reduction, so the replicas need no collective, as the JAX
package's sharded jit has none.  On a (data, model) grid
(``parallel.mesh.make_mesh_2d``) with a sharded model both predictors run
on every rank: each data rank answers its own rows, and the model ranks
of a data group, which reduce over their group inside the model, return
the same output.
"""
from __future__ import annotations

import copy
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from equss_tpu_torch.core import trace
from equss_tpu_torch.data.transforms import normalize_images

DEFAULT_PATH = "model.pt2"
MAX_SYMBOLIC_BATCH = 4096
PLATFORMS_FILE = "equss_platforms"     # the artifact's extra file listing its devices
DEVICE_TYPES = ("cuda", "cpu")


class Predictor(nn.Module):
    """``img`` (b, H, W, 3) -> ``{"cluster_preds", "linear_preds"}``
    int32 (b, H, W): ``normalize_images`` (with ``normalize``), the
    model's inference forward, the trainer's ``_select_out``, then both
    probes against an all ``-1`` label plane at the input's resolution.
    Without a cluster probe only ``linear_preds``."""

    def __init__(self, trainer, *, normalize: bool = True):
        super().__init__()
        self.model = trainer.model
        self.evaluator = trainer.evaluator
        self.select_out = trainer._select_out
        self.normalize = normalize

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.normalize:
            img = normalize_images(img)
        with torch.no_grad():
            out = self.model(img, training=False)
            label = torch.full(img.shape[:3], -1, dtype=torch.int64, device=img.device)
            with trace.span("equss.probes"):
                ev = self.evaluator(self.select_out(out), label)
        res = {"linear_preds": ev["linear_preds"]}
        if "cluster_preds" in ev:
            res["cluster_preds"] = ev["cluster_preds"]
        return res


def build_predict_fn(trainer, *, normalize: bool = True) -> Predictor:
    """The live predictor of the trainer's current weights, in eval mode,
    on the trainer's device."""
    return Predictor(trainer, normalize=normalize).eval()


class ShardedPredictor:
    """``predict(img)`` over one ``Predictor`` replica per device of
    ``devices``: img (b, H, W, 3) with b divisible by the device count is
    split into equal consecutive chunks, chunk i runs on device i, and the
    outputs come back concatenated in order on the first device."""

    def __init__(self, trainer, devices: Sequence[Union[str, torch.device]], *,
                 normalize: bool = True):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("build_sharded_predict_fn needs at least one device")
        self.replicas = [build_predict_fn(_on(trainer, d), normalize=normalize)
                         for d in self.devices]

    def __call__(self, img) -> Dict[str, torch.Tensor]:
        img = torch.as_tensor(img)
        n = len(self.devices)
        if img.shape[0] % n:
            raise ValueError(f"batch {img.shape[0]} does not divide evenly over {n} devices")
        outs = [predict(chunk.to(dev, non_blocking=True))
                for predict, dev, chunk in zip(self.replicas, self.devices, img.chunk(n))]
        return {k: torch.cat([o[k].to(self.devices[0]) for o in outs]) for k in outs[0]}


def _on(trainer, device: torch.device):
    """The trainer itself where it runs on ``device``, else what a
    ``Predictor`` reads of it (model, evaluator, ``_select_out``) with
    copies of the model and the evaluator on ``device``."""
    home = next(trainer.evaluator.parameters()).device        # with its index
    if device.type == home.type and (device.type == "cpu" or device.index == home.index):
        return trainer
    model = copy.deepcopy(trainer.model).to(device)
    model.device = device
    evaluator = copy.deepcopy(trainer.evaluator).to(device)
    return types.SimpleNamespace(model=model, evaluator=evaluator,
                                 _select_out=trainer._select_out)


def build_sharded_predict_fn(trainer, devices: Sequence[Union[str, torch.device]], *,
                             normalize: bool = True) -> ShardedPredictor:
    """The live predictor of the trainer's current weights with each
    request's batch split evenly over ``devices`` (``mesh.make_mesh()``:
    the visible cards), one replica per device, in eval mode."""
    return ShardedPredictor(trainer, devices, normalize=normalize)


def export_devices(platforms: Union[None, str, Sequence[str]]) -> Optional[List[str]]:
    """``export.platforms`` -> the device types an artifact serves, in
    order, each ``cuda`` or ``cpu``; None when not given.  A string may be
    one item or a comma list (``export.platforms=cuda,cpu`` on the
    command line)."""
    if platforms is None:
        return None
    if isinstance(platforms, str):
        platforms = [p.strip() for p in platforms.split(",") if p.strip()]
    out: List[str] = []
    for p in platforms:
        if p not in DEVICE_TYPES:
            raise ValueError(f"export.platforms must be cuda or cpu, got {p!r}")
        if p not in out:
            out.append(p)
    return out or None


def export_predictor(trainer, img_hw: Tuple[int, int], *, batch_size: int = 1,
                     normalize: bool = True,
                     platforms: Union[None, str, Sequence[str]] = None,
                     symbolic_batch: str = "auto") -> torch.export.ExportedProgram:
    """Export the predictor of the trainer's weights for (b, H, W, 3)
    float32 input, traced on the trainer's device, for the devices of
    ``platforms`` (``export_devices``; default the trainer's device type,
    which it must list).  The list rides on the program as ``platforms``
    and ``save_predictor`` writes it into the artifact.

    ``symbolic_batch="auto"`` tries a symbolic batch dimension first and
    pins ``batch_size`` if that fails, printing why; ``"off"`` pins it up
    front.  The live predictor runs once on the example input before the
    trace, which also fills the model's host-side caches (resize matrices,
    normalisation constants) with real tensors."""
    if symbolic_batch not in ("auto", "off"):
        raise ValueError(f"export.symbolic_batch must be auto|off, got {symbolic_batch}")
    want = export_devices(platforms) or [trainer.device.type]
    if trainer.device.type not in want:
        raise ValueError(f"export.platforms asks for {want}, the trainer runs on "
                         f"{trainer.device}; build the trainer on one of them")
    predict = build_predict_fn(trainer, normalize=normalize)
    H, W = img_hw

    def example(b: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(0)
        return torch.rand((b, H, W, 3), generator=g).to(trainer.device)

    def trace(b: int, dynamic_shapes=None) -> torch.export.ExportedProgram:
        img = example(b)
        # with autograd off around the trace, the forward's own no_grad
        # regions leave no grad-mode nodes in the graph
        with torch.no_grad():
            predict(img)
            return torch.export.export(predict, (img,), dynamic_shapes=dynamic_shapes)

    exported = None
    if symbolic_batch == "auto":
        batch = torch.export.Dim("batch", min=1, max=MAX_SYMBOLIC_BATCH)
        try:
            # a batch of 1 in the example would specialise the dimension to 1
            exported = trace(max(batch_size, 2), ({0: batch},))
        except Exception as e:  # noqa: BLE001 - any trace failure pins the batch
            print(f"export: symbolic batch unavailable "
                  f"({type(e).__name__}: {str(e).splitlines()[0][:160]}); "
                  f"pinning batch_size={batch_size}", flush=True)
    if exported is None:
        exported = trace(batch_size)
    exported.platforms = want
    return exported


def save_predictor(exported: torch.export.ExportedProgram, path: str = DEFAULT_PATH) -> str:
    """Write the artifact, with the devices it serves (``platforms``)."""
    plats = getattr(exported, "platforms", None) or [_program_device(exported).type]
    torch.export.save(exported, path, extra_files={PLATFORMS_FILE: ",".join(plats)})
    return path


def _program_device(exported: torch.export.ExportedProgram) -> torch.device:
    """The device of a program's weights and constants (the CPU without)."""
    tensors = list(exported.state_dict.values()) + list(exported.constants.values())
    return next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                torch.device("cpu"))


def load_predictor(path: str, device: Union[None, str, torch.device] = None) -> Callable:
    """Read an artifact into ``predict(img) -> {"cluster_preds",
    "linear_preds"}`` on ``device`` (default the device it was traced on),
    which the artifact must list; on another listed device the program is
    moved there.  ``img`` (a tensor or a numpy array) goes to that device;
    uint8 is divided by 255, as ``normalize_images`` does, since the
    artifact takes [0, 1] floats.  Imports the kernels' op registrations
    and nothing of the model."""
    import equss_tpu_torch.ops  # noqa: F401 - registers the equss:: ops

    extra = {PLATFORMS_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    home = _program_device(exported)
    listed = [p for p in extra[PLATFORMS_FILE].split(",") if p] or [home.type]
    device = home if device is None else torch.device(device)
    if device.type not in listed:
        raise ValueError(f"{path} serves {listed}, not {device.type}; export it with "
                         f"export.platforms={','.join(listed + [device.type])}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device != home:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    module = exported.module()

    def predict(img) -> Dict[str, torch.Tensor]:
        img = torch.as_tensor(img).to(device)
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        return module(img.float())

    return predict
