"""CLI trainer: ``python -m equss_tpu_torch.cli --config configs/X.yaml [a.b=c ...]``.

The port's counterpart of ``equss_tpu/cli.py``'s train job: config ->
seed -> data -> trainer -> epoch loop with periodic validation and a
checkpoint on each new best -> the best checkpoint reloaded -> the final
evaluation, and with ``eval.final_crf`` the CRF-refined one.  Metrics go
to ``<save_dir>/<wandb.name>_<time>/metrics.jsonl`` and checkpoints to
its ``ckpt/``.

``resume.checkpoint=<ckpt dir>`` restores the latest checkpoint there:
``resume.mode=eval`` (the default) runs the final evaluation on it and
stops; ``resume.mode=train`` continues the run from its step.

The run takes the CUDA card unless ``device`` says otherwise
(``run(cfg, device="cpu")``, or the override ``device=cpu``).  Only
synthetic data (``dataset.synthetic: true``) is ported; the ``crop``,
``pack``, ``knn`` and ``export`` jobs, real datasets, multi-process runs
and ``train.profile_dir`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from equss_tpu_torch.device import DeviceLike, resolve_device

JOBS = ("train", "crop", "knn", "export", "pack")


def _load_backbone(cfg: Dict[str, Any]) -> Optional[Dict[str, torch.Tensor]]:
    """The DINO weights of ``model.pretrained.pretrained_weights`` as the
    port's backbone state dict, or None without a path."""
    path = cfg["model"]["pretrained"].get("pretrained_weights")
    if not path:
        return None
    from equss_tpu_torch.convert import load_dino_state_dict

    return load_dino_state_dict(path)


def _make_batch_fns(cfg: Dict[str, Any]):
    """``(train_batches(epoch), val_batches(), res)``: synthetic batches
    with the JAX package's seeds and counts; sets ``cfg['_iter_per_epoch']``
    (the cosine schedules' horizon and the resume epoch)."""
    seed = cfg.get("seed", 0)
    if not cfg.get("dataset", {}).get("synthetic"):
        raise NotImplementedError(
            "real datasets (equss_tpu/data/pipeline.py) are not ported yet; "
            "set dataset.synthetic=true")
    from equss_tpu_torch.data.synthetic import synthetic_batches

    res = cfg["dataset"]["train"]["res"]
    vres = cfg["dataset"]["val"]["res"]
    bs = cfg["dataloader"]["train"]["batch_size"]
    vbs = cfg["dataloader"]["val"]["batch_size"]
    nb = cfg["dataset"].get("synthetic_batches", 16)
    ncls = cfg["num_classes"]

    def train_batches(epoch: int):
        return synthetic_batches(seed + epoch, nb, bs, res, ncls)

    def val_batches():
        return synthetic_batches(seed + 10_000, max(nb // 4, 1), vbs, vres, ncls,
                                 with_pos=False)

    cfg["_iter_per_epoch"] = nb
    return train_batches, val_batches, res


def _final_eval(cfg: Dict[str, Any], trainer, val_batches, logger) -> Dict[str, Any]:
    """The final evaluation of the trainer's state, logged at its step as
    ``final_*``; with ``eval.final_crf`` also the CRF-refined one, logged
    as ``final_crf_*`` and returned under ``crf_*``."""
    step = trainer.step
    viz_dir = None
    if cfg.get("is_visualize") and cfg.get("visualize_path"):
        viz_dir = os.path.join(cfg["visualize_path"], str(step))
    final_crf = cfg.get("eval", {}).get("final_crf", False)
    final = trainer.validate(val_batches(), visualize_to=None if final_crf else viz_dir)
    logger.log({f"final_{k}": v for k, v in final.items()}, step=step)
    if final_crf:
        print("final_crf: running the CRF-refined evaluation (exact mean field, "
              "two probes per image)", flush=True)
        t0 = time.time()
        crf_metrics = trainer.validate_crf(val_batches(), visualize_to=viz_dir)
        print(f"final_crf: done in {time.time() - t0:.1f}s", flush=True)
        logger.log({f"final_crf_{k}": v for k, v in crf_metrics.items()}, step=step)
        final.update({f"crf_{k}": v for k, v in crf_metrics.items()})
    return final


def _wandb_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """cfg['wandb'] -> ``wandb.init`` keyword arguments, the config included."""
    w = dict(cfg.get("wandb", {}) or {})
    w.setdefault("config", {k: v for k, v in cfg.items() if k != "wandb"})
    return w


def _run_dir(cfg: Dict[str, Any]) -> str:
    """``<save_dir>/<wandb.name>_<time>``, with a suffix where a run of the
    same second already took the name."""
    base = os.path.join(cfg.get("save_dir", "output"),
                        (cfg.get("wandb", {}) or {}).get("name", "run") + "_"
                        + time.strftime("%Y%m%d_%H%M%S"))
    path, i = base, 1
    while os.path.exists(path):
        path, i = f"{base}_{i}", i + 1
    return path


def run(cfg: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The train job of a resolved config.  ``device`` (default
    ``cfg['device']``, else CUDA) is where the trainer runs.  Returns
    ``{"state": weights after the last step, "best": best validation}``,
    or for ``resume.mode: eval`` the final metrics under ``best``."""
    from equss_tpu_torch.core.checkpoint import CheckpointManager
    from equss_tpu_torch.core.logging import MetricsLogger
    from equss_tpu_torch.train.trainer import Trainer

    dist = cfg.get("dist", {}) or {}
    if int(dist.get("num_processes", 1) or 1) > 1 or dist.get("auto"):
        raise NotImplementedError("multi-process runs (parallel/mesh.py) are not ported yet")
    if cfg.get("train", {}).get("profile_dir"):
        raise NotImplementedError("train.profile_dir is not ported yet")
    dev = resolve_device(device if device is not None else cfg.get("device"))
    save_dir = _run_dir(cfg)
    logger = MetricsLogger(save_dir=save_dir, use_wandb=not cfg.get("debug", False),
                           wandb_cfg=_wandb_cfg(cfg), is_master=True)
    logger.banner(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")

    train_batches, val_batches, res = _make_batch_fns(cfg)
    trainer = Trainer(cfg, device=dev)
    backbone = _load_backbone(cfg)
    if backbone is not None:
        trainer.model.backbone.load_state_dict(backbone)

    resume = cfg.get("resume", {}) or {}
    resume_state = None
    if resume.get("checkpoint"):
        restored = CheckpointManager(resume["checkpoint"]).restore()
        if resume.get("mode", "eval") == "eval":
            trainer.load_train_state(restored, resume_training=False)
            final = _final_eval(cfg, trainer, val_batches, logger)
            logger.banner(f"eval-only: {final}")
            logger.close()
            return {"state": trainer.state_dict(), "best": final}
        resume_state = restored

    ckpt = CheckpointManager(os.path.join(save_dir, "ckpt"))
    result = trainer.fit(train_batches, val_batches, logger=logger, checkpointer=ckpt,
                         img_hw=(res, res), state=resume_state)
    logger.banner(f"best: {result['best']}")
    # fit saves on each new best only, so the latest step saved is the best
    if ckpt.latest_step() is not None:
        trainer.load_train_state(ckpt.restore(), resume_training=False)
    _final_eval(cfg, trainer, val_batches, logger)
    ckpt.close()
    logger.close()
    return result


def main(argv: Optional[List[str]] = None):
    from equss_tpu_torch.core.config import prepare_config
    from equss_tpu_torch.core.random import set_seed

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    job = "train"
    if argv and argv[0] in JOBS:
        job = argv.pop(0)
    cfg, _ = prepare_config(argv)
    set_seed(cfg.get("seed", 0))
    if job != "train":
        raise NotImplementedError(f"the {job} job is not ported yet (equss_tpu/cli.py)")
    return run(cfg)


if __name__ == "__main__":
    main()
