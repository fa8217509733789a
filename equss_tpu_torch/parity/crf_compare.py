"""The exact mean field against the permutohedral lattice, on twin-corpus
metrics.

The port's counterpart of ``equss_tpu/parity/crf_compare.py``.  It
trains the twin config (``parity/twin.py``) briefly on the miniature twin
corpus with the port's ``Trainer``, computes the probes' log-probs once
per val batch with the model and evaluator of the valid step, then
refines the same log-probs twice:

* exactly, on the device: ``ops/crf.py::dense_crf`` (the streamed dense
  kernel, bf16 messages), timed with a device synchronisation;
* approximately, on the host: ``ops/crf_native.py::batched_crf_native``,
  the port's build of ``native/permutohedral.cpp`` (pydensecrf's lattice
  splat / blur / slice structure).

It scores none, exact and lattice with the same metric stack
(``eval/metrics.py``: the cluster probe Hungarian-matched, the linear
probe as is) and reports the per-pixel agreement of the two refined
argmaxes and each refinement's ms per image and probe.  pydensecrf itself
cannot be installed here, so the agreement bounds the metric-level effect
of the lattice's approximation, the order of pydensecrf's own deviation
from the exact mean field.

    python3 -m equss_tpu_torch.parity.crf_compare [--device cpu]

``run_crf_compare`` builds the trainer and the corpus and trains;
``compare`` scores a trainer as it stands (a test loads weights into it
first).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from equss_tpu_torch.device import DeviceLike, synchronize
from equss_tpu_torch.ops.crf import CRFConfig


def train_steps(trainer, train: List[Mapping[str, np.ndarray]], n_steps: int) -> None:
    """``n_steps`` train steps over the corpus's train batches, in turn."""
    for i in range(n_steps):
        b = train[i % len(train)]
        trainer.train_step({"img": b["img"], "img_pos": b["img_pos"], "label": b["label"]})


def log_probs(trainer, img_n: torch.Tensor, label: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The linear and cluster probes' label-resolution log-probs (b, H, W,
    C) of normalised images, from the valid step's inference forward."""
    with torch.no_grad():
        out = trainer.model(img_n, training=False)
        ev = trainer.evaluator(trainer._select_out(out), label, want_log_probs=True)
    return ev["linear_log_probs"], ev["cluster_log_probs"]


def refine_exact(img_n: torch.Tensor, lp: torch.Tensor, cfg: CRFConfig) -> torch.Tensor:
    """The argmax (b, H, W) int32 of ``dense_crf`` of each image, on the
    device of its inputs."""
    from equss_tpu_torch.ops.crf import batched_crf

    with torch.no_grad():
        return batched_crf(img_n, lp, cfg).argmax(-1).to(torch.int32)


def refine_lattice(img_n: torch.Tensor, lp: torch.Tensor, cfg: CRFConfig) -> np.ndarray:
    """The argmax (b, H, W) int32 of the host lattice's mean field of each
    image, on the [0, 255] RGB the normalised images came from."""
    from equss_tpu_torch.data.transforms import unnormalize_images
    from equss_tpu_torch.ops.crf_native import batched_crf_native

    rgb255 = unnormalize_images(img_n).cpu().numpy() * 255.0
    return np.argmax(batched_crf_native(rgb255, lp.cpu().numpy(), cfg), -1).astype(np.int32)


def compare(trainer, val: List[Mapping[str, np.ndarray]],
            crf_cfg: CRFConfig = CRFConfig()) -> Dict[str, Any]:
    """Score the trainer's state on the val batches: none, exact and
    lattice (Cluster/Linear mIoU and Accuracy in percent), the exact and
    lattice argmaxes' agreement per probe, ms per image and probe of each
    refinement, the image count."""
    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.eval.metrics import UnSegMetrics, confusion_update

    dev = trainer.device
    nc, extra = trainer.tc.num_classes, trainer.tc.extra_classes
    metrics = {k: (UnSegMetrics(nc, extra, compute_hungarian=True),
                   UnSegMetrics(nc, 0, compute_hungarian=False))
               for k in ("none", "exact", "lattice")}
    agree: Dict[str, list] = {"cluster": [], "linear": []}
    t_exact = t_lattice = 0.0
    n_imgs = 0
    for b in val:
        img_n = normalize_images(torch.from_numpy(b["img"]).to(dev))
        label = torch.from_numpy(b["label"]).to(dev).long()
        lin_lp, clu_lp = log_probs(trainer, img_n, label)
        n_imgs += img_n.shape[0]
        preds = {"none": (lin_lp.argmax(-1).to(torch.int32), clu_lp.argmax(-1).to(torch.int32))}

        synchronize(dev)
        t0 = time.perf_counter()
        preds["exact"] = (refine_exact(img_n, lin_lp, crf_cfg),
                          refine_exact(img_n, clu_lp, crf_cfg))
        synchronize(dev)
        t_exact += time.perf_counter() - t0

        t0 = time.perf_counter()
        lattice = (refine_lattice(img_n, lin_lp, crf_cfg),
                   refine_lattice(img_n, clu_lp, crf_cfg))
        t_lattice += time.perf_counter() - t0
        preds["lattice"] = tuple(torch.from_numpy(p).to(dev) for p in lattice)

        for i, probe in enumerate(("linear", "cluster")):
            agree[probe].append((preds["exact"][i] == preds["lattice"][i])
                                .float().mean().item())
        for k, (lin_p, clu_p) in preds.items():
            cm, lm = metrics[k]
            cm.update_confusion(confusion_update(clu_p, label, nc, extra).cpu())
            lm.update_confusion(confusion_update(lin_p, label, nc, 0).cpu())

    rows = {}
    for k, (cm, lm) in metrics.items():
        c, lin = cm.compute(), lm.compute()
        rows[k] = {"Cluster_mIoU": c["iou"], "Cluster_Accuracy": c["accuracy"],
                   "Linear_mIoU": lin["iou"], "Linear_Accuracy": lin["accuracy"]}
    return {
        "metrics": rows,
        "agreement": {k: float(np.mean(v)) for k, v in agree.items()},
        "ms_per_img": {"exact": 1e3 * t_exact / (2 * n_imgs),
                       "lattice": 1e3 * t_lattice / (2 * n_imgs)},
        "n_imgs": n_imgs, "res": int(val[0]["img"].shape[1]),
    }


def run_crf_compare(*, n_steps: int = 40, batch_size: int = 4, res: int = 64, n_val: int = 4,
                    seed: int = 0, device: DeviceLike = None,
                    cfg: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Train ``cfg`` (default ``make_twin_config()``), weights from
    ``seed``, for ``n_steps`` steps at ``batch_size`` and ``res`` on the
    twin corpus on ``device`` (default the CUDA card), then ``compare``
    over ``n_val`` val batches."""
    from equss_tpu_torch.parity.twin import make_corpus, make_twin_config
    from equss_tpu_torch.train.trainer import Trainer

    cfg = make_twin_config() if cfg is None else cfg
    trainer = Trainer(cfg, device=device, seed=seed)
    train, val = make_corpus(seed, max(n_steps, 1), n_val, batch_size, res, cfg["num_classes"])
    train_steps(trainer, train, n_steps)
    return compare(trainer, val)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-steps", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--n-val", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run_crf_compare(n_steps=args.n_steps, batch_size=args.batch_size, res=args.res,
                          n_val=args.n_val, seed=args.seed, device=args.device)
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
