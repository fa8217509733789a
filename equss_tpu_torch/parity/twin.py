"""The twin configuration and corpus, without the twin.

The port's copy of the two reference-free parts of
``equss_tpu/parity/twin.py``: ``make_twin_config`` (the flagship pqgo
config at twin widths, and its ``stego``, ``sl`` and ``spq`` variants,
with every stochastic knob off) and ``make_corpus`` (the miniature
synthetic corpus).  ``parity/crf_compare.py`` runs on them.

The rest of the JAX module is not ported: ``TorchTwin``,
``transplant_weights`` and the twin run train the upstream torch
repository (a local checkout, imported as an oracle) beside the JAX
trainer, and so do ``parity/module_twin.py`` and ``parity/run.py``;
without that checkout they cannot run.  The port's parity with the JAX
package lives in its own tests (``tests/test_torch_*.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def make_twin_config(
    *,
    variant: str = "pqgo",
    model_type: str = "vit_small",
    patch_size: int = 8,
    embed_dim: int = 64,
    num_pq: int = 8,
    num_codebook: int = 32,
    num_classes: int = 4,
    feature_samples: int = 5,
    neg_samples: int = 2,
    lr_model: float = 3.0e-4,
    lr_probe: float = 3.0e-3,
) -> Dict[str, Any]:
    """The twin config dict, equal to the JAX package's for the same
    arguments.  variant: 'pqgo' (flagship, quantized), 'stego' (STEGO
    baseline family, dino_stego.py:11-66), 'sl' (supervised) or 'spq'
    (the soft-PQ VQ-trainer family)."""
    cfg = {
        "seed": 0,
        "num_classes": num_classes,
        "dataset_name": "cocostuff27",
        "model": {
            "name": "pqgo",
            "pretrained": {
                "model_type": model_type,
                "dino_patch_size": patch_size,
                "freeze_backbone": True,
                "dropout": False,
                "drop_prob": 0.0,              # determinism: no dropout
                "pretrained_weights": None,     # random weights from the seed
                "precision": "f32",
            },
            "vq": {
                "vq_type": "param",
                "num_codebooks": [num_codebook],
                "embed_dims": [embed_dim],
                "beta": 0.25,
                "book": 1.0,
                "normalize": "l2",
                "use_restart": False,
                "use_split": False,
                "use_weighted_sum": False,
                "use_gumbel": False,
                "need_initialized": "none",
                "pq_dropout": 0.0,
                "num_pq": [num_pq],
                "assign_precision": "exact",
            },
        },
        "loss": {
            "stego_weight": 1.0,
            "vq_weight": 1.0,
            "stego": {
                "neg_inter_weight": 0.63, "pos_inter_weight": 0.25,
                "pos_intra_weight": 0.67, "neg_inter_shift": 0.66,
                "pos_inter_shift": 0.02, "pos_intra_shift": 0.08,
                "zero_clamp": True, "pointwise": True, "stabilize": False,
                "feature_samples": feature_samples,
                "neg_samples": neg_samples,
            },
            "jsd": {"temperature": 1.0},
        },
        "optimizer": {
            "model": {"name": "adam", "lr": lr_model, "weight_decay": 0.0},
            "cluster": {"name": "adam", "lr": lr_probe},
            "linear": {"name": "adam", "lr": lr_probe},
        },
        "scheduler": {
            "model": {"name": "constant"},
            "cluster": {"name": "constant"},
            "linear": {"name": "constant"},
        },
        "eval": {"output_type": "vq0", "extra_classes": 0,
                 "probe_res": "label"},        # reference-exact probes
        "train": {"max_epochs": 1, "clip_grad": 10.0, "num_accum": 1,
                  "print_interval_iters": 1000,
                  "valid_interval_iters": 100000},
    }
    cfg["model"]["name"] = variant
    if variant == "sl":
        # supervised family (sl_train.py + SupervisedWrapper): total IS
        # the probe CE; the stego loss is computed but never added
        # (SupervisedWrapper.py:45), and the probe itself is never in an
        # optimizer (sl_train.py:412-416 builds ONLY the model opt) —
        # mirrored here with linear lr=0 so our always-stepped probe
        # receives zero updates
        cfg["model"]["pretrained"]["dim"] = embed_dim
        cfg["loss"].update(cfg["loss"]["stego"])
        cfg["loss"].pop("vq_weight", None)
        cfg["loss"].pop("stego_weight", None)
        cfg["eval"]["output_type"] = "feat"
        cfg["optimizer"]["linear"] = {"name": "adam", "lr": 0.0}
    elif variant == "stego":
        # head/code dim the reference wrapper sizes its evaluator with
        # (StegoWrapper.py:28-33)
        cfg["model"]["pretrained"]["dim"] = embed_dim
        # the reference's STEGO model reads the loss knobs directly off
        # cfg['loss'] (dino_stego.py:25 STEGOLoss(cfg['loss']), keys used
        # flat, loss.py:682-708); our side reads loss['stego'] — expose
        # the SAME values both ways
        cfg["loss"].update(cfg["loss"]["stego"])
        # no quantizer: a configured vq_weight without a vq-loss aux key
        # fails loudly in the Trainer (trainer.py:209-226)
        cfg["loss"].pop("vq_weight", None)
        # probes see the code map, not a quantized output
        # (StegoWrapper.py:50-53)
        cfg["eval"]["output_type"] = "feat"
    elif variant == "spq":
        # the VQ-trainer family (train_vq.py + NewVQWrapper + DINOSPQ):
        # jsd-only objective per spq_baseline.yaml:50-55; every other
        # weight present-but-zero because the wrapper reads them
        # unconditionally (NewVQWrapper.py:28-32)
        cfg["model"]["vq"]["use_kmeans_sampling"] = False
        cfg["loss"].pop("stego_weight", None)
        cfg["loss"].update({
            "recon_weight": 0.0, "vq_weight": 0.0, "info_nce_weight": 0.0,
            "jsd_weight": 1.0, "margin_weight": 0.0,
            "info_nce": {"normalize": "l2", "neg_sample": 2,
                         "temperature": 1.0, "cal_type": "cosine"},
            "jsd": {"temperature": 1.0, "entropy_weight": 0.0},
        })
    return cfg


def make_corpus(seed: int, n_train: int, n_val: int, batch_size: int,
                res: int, num_classes: int) -> Tuple[List[Dict], List[Dict]]:
    """Miniature corpus: ``n_train`` train batches (with kNN positives and
    the photometric view) and ``n_val`` val batches of ``batch_size``
    images at ``res`` from ``data/synthetic.py``, each image also
    normalised on the host (``img_norm``, ``img_pos_norm``,
    ``aug_img_norm``): the same arrays as the JAX package's
    ``make_corpus`` for the same arguments."""
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.data.transforms import normalize_images

    def norm(x: np.ndarray) -> np.ndarray:
        return normalize_images(torch.from_numpy(x)).numpy()

    def prep(batches, with_pos):
        out = []
        for b in batches:
            item = {"label": b["label"], "img": b["img"], "img_norm": norm(b["img"])}
            if with_pos:
                item["img_pos"] = b["img_pos"]
                item["img_pos_norm"] = norm(b["img_pos"])
                item["aug_img"] = b["aug_img"]
                item["aug_img_norm"] = norm(b["aug_img"])
            out.append(item)
        return out

    train = prep(synthetic_batches(seed, n_train, batch_size, res=res,
                                   num_classes=num_classes), True)
    val = prep(synthetic_batches(seed + 1000, n_val, batch_size, res=res,
                                 num_classes=num_classes, with_pos=False), False)
    return train, val
