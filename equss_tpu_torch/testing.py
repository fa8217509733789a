"""Shared tiny model config for tests and smoke runs.

The port's copy of ``equss_tpu/testing.py``: a vit_micro pqgo config
(config/pqgo_baseline.yaml's structure at toy scale) that trains in
seconds on the CPU, used by the tools' CPU smoke runs
(``equss_tpu_torch/tools``) and ad-hoc scripts.  It returns the same dict
as the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict


def tiny_pqgo_cfg(num_classes: int = 4) -> Dict[str, Any]:
    return {
        "seed": 0,
        "num_classes": num_classes,
        "model": {
            "name": "pqgo",
            "pretrained": {
                "model_type": "vit_micro", "dino_patch_size": 8,
                "freeze_backbone": True, "dropout": True, "drop_prob": 0.1,
            },
            "vq": {
                "vq_type": "ema", "num_codebooks": [16], "embed_dims": [64],
                "beta": 0.25, "book": 1.0, "normalize": "none",
                "need_initialized": "uni", "num_pq": [8],
                "decay": 0.99, "eps": 1.0e-5,
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
                "feature_samples": 3, "neg_samples": 1,
            },
        },
        "optimizer": {
            "model": {"name": "adam", "lr": 3.0e-4},
            "cluster": {"name": "adam", "lr": 3.0e-3},
            "linear": {"name": "adam", "lr": 3.0e-3},
        },
        "scheduler": {
            "model": {"name": "constant"},
            "cluster": {"name": "constant"},
            "linear": {"name": "constant"},
        },
        "eval": {"output_type": "vq0", "extra_classes": 0},
        "train": {"max_epochs": 1, "print_interval_iters": 1,
                  "valid_interval_iters": 100, "clip_grad": 10.0,
                  "num_accum": 1},
    }
