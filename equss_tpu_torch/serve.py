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

An artifact holds one device's ops and runs on the device it was
exported for.  Its batch is symbolic under ``symbolic_batch="auto"``
(pinned at ``batch_size`` if the symbolic export fails, with the reason
printed) and pinned under ``"off"``.  On CUDA the quantizer's ``auto``
route always takes the kernel, so a symbolic artifact keeps it; on the
CPU a symbolic trace takes the plain route, as the JAX package's does.
Serving across several cards (``build_sharded_predict_fn``) is not
ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from equss_tpu_torch.data.transforms import normalize_images

DEFAULT_PATH = "model.pt2"
MAX_SYMBOLIC_BATCH = 4096


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
            ev = self.evaluator(self.select_out(out), label)
        res = {"linear_preds": ev["linear_preds"]}
        if "cluster_preds" in ev:
            res["cluster_preds"] = ev["cluster_preds"]
        return res


def build_predict_fn(trainer, *, normalize: bool = True) -> Predictor:
    """The live predictor of the trainer's current weights, in eval mode,
    on the trainer's device."""
    return Predictor(trainer, normalize=normalize).eval()


def build_sharded_predict_fn(trainer, *args, **kwargs):
    """Serving with the batch split across several cards needs the
    multi-card layer (``parallel/mesh.py``), which is not ported yet."""
    raise NotImplementedError(
        "build_sharded_predict_fn (serving across cards, parallel/mesh.py) is not ported yet")


def export_device(platforms: Union[None, str, Sequence[str]]) -> Optional[str]:
    """``export.platforms`` -> the one device type an artifact is exported
    for (``cuda`` or ``cpu``), None when not given.  A string may be one
    item or a comma list (``export.platforms=cuda`` on the command line);
    more than one device raises ``NotImplementedError``."""
    if platforms is None:
        return None
    if isinstance(platforms, str):
        platforms = [p.strip() for p in platforms.split(",") if p.strip()]
    platforms = list(platforms)
    if len(platforms) > 1:
        raise NotImplementedError(
            f"export.platforms {platforms}: a torch.export artifact holds one "
            f"device's ops; export once per device")
    if not platforms:
        return None
    if platforms[0] not in ("cuda", "cpu"):
        raise ValueError(f"export.platforms must be cuda or cpu, got {platforms[0]!r}")
    return platforms[0]


def export_predictor(trainer, img_hw: Tuple[int, int], *, batch_size: int = 1,
                     normalize: bool = True,
                     platforms: Union[None, str, Sequence[str]] = None,
                     symbolic_batch: str = "auto") -> torch.export.ExportedProgram:
    """Export the predictor of the trainer's weights for (b, H, W, 3)
    float32 input on the trainer's device (``platforms``, when given,
    must name it).

    ``symbolic_batch="auto"`` tries a symbolic batch dimension first and
    pins ``batch_size`` if that fails, printing why; ``"off"`` pins it up
    front.  The live predictor runs once on the example input before the
    trace, which also fills the model's host-side caches (resize matrices,
    normalisation constants) with real tensors."""
    if symbolic_batch not in ("auto", "off"):
        raise ValueError(f"export.symbolic_batch must be auto|off, got {symbolic_batch}")
    want = export_device(platforms)
    if want is not None and want != trainer.device.type:
        raise ValueError(f"export.platforms asks for {want}, the trainer runs on "
                         f"{trainer.device}; build the trainer on {want}")
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

    if symbolic_batch == "off":
        return trace(batch_size)
    batch = torch.export.Dim("batch", min=1, max=MAX_SYMBOLIC_BATCH)
    try:
        # a batch of 1 in the example would specialise the dimension to 1
        return trace(max(batch_size, 2), ({0: batch},))
    except Exception as e:  # noqa: BLE001 - any trace failure pins the batch
        print(f"export: symbolic batch unavailable "
              f"({type(e).__name__}: {str(e).splitlines()[0][:160]}); "
              f"pinning batch_size={batch_size}", flush=True)
    return trace(batch_size)


def save_predictor(exported: torch.export.ExportedProgram, path: str = DEFAULT_PATH) -> str:
    torch.export.save(exported, path)
    return path


def load_predictor(path: str) -> Callable:
    """Read an artifact into ``predict(img) -> {"cluster_preds",
    "linear_preds"}``.  ``img`` (a tensor or a numpy array) goes to the
    artifact's device; uint8 is divided by 255, as ``normalize_images``
    does, since the artifact takes [0, 1] floats.  Imports the kernels'
    op registrations and nothing of the model."""
    import equss_tpu_torch.ops  # noqa: F401 - registers the equss:: ops

    exported = torch.export.load(path)
    tensors = list(exported.state_dict.values()) + list(exported.constants.values())
    device = next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                  torch.device("cpu"))
    module = exported.module()

    def predict(img) -> Dict[str, torch.Tensor]:
        img = torch.as_tensor(img).to(device)
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        return module(img.float())

    return predict
