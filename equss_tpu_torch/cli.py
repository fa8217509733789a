"""CLI: ``python -m equss_tpu_torch.cli [train|crop|knn|pack|export]
--config configs/X.yaml [a.b=c ...]``.

The port's counterpart of ``equss_tpu/cli.py``.  Jobs:

* ``train`` (the default): config -> seed -> data -> trainer -> epoch
  loop with periodic validation and a checkpoint on each new best -> the
  best checkpoint reloaded -> the final evaluation, and with
  ``eval.final_crf`` the CRF-refined one.  Metrics go to
  ``<save_dir>/<wandb.name>_<time>/metrics.jsonl`` and checkpoints to its
  ``ckpt/``.  The data are the corpus of ``dataset.train`` / ``.val``
  (``data/pipeline.py``; the train split's kNN positives from the
  ``knn`` job's cache), or synthetic batches with ``dataset.synthetic``.
  ``resume.checkpoint=<ckpt dir>`` restores the latest checkpoint there:
  ``resume.mode=eval`` (the default) runs the final evaluation on it and
  stops; ``resume.mode=train`` continues the run from its step.
* ``crop``: the five-crop corpus of the train split
  (``data/jobs.py::materialize_crops``).
* ``knn``: the kNN-positive cache of the train split
  (``data/jobs.py::precompute_knns``), at
  ``<data_dir>/nns/nns_<model_type>_<dataset>_train_<crop_type>_224.npz``.
* ``pack``: the packed decoded corpus of each split (``data/cache.py``),
  which ``dataloader.<split>.pack: auto`` then reads.
* ``export``: the predictor of ``resume.checkpoint`` as a
  ``torch.export`` artifact (``serve.py``) at ``export.path`` (default
  ``model.pt2``).

The jobs that run a model (train, knn, export) build it through
``models/registry.py`` (every model the registry builds: ``pqgo`` and
``vq``, ``stego``, ``probe``, ``sl``) and take the CUDA card unless
``device`` says otherwise (``run(cfg, device="cpu")``, or the override
``device=cpu``; ``export.platforms`` lists the export's devices); crop and
pack are host work.  ``train.profile_dir`` traces the train job from the
start of training to its end, the final evaluation included, with
``torch.profiler`` (host ops and, on CUDA, the kernels; the port's
kernels appear as their ops, ``equss::attention_qkv``,
``equss::pq_assign``, ...), and writes the Chrome trace
``<profile_dir>/trace_rank<r>.json`` when the run ends, also where it
raises.

The train job runs on several processes as one global program
(``parallel/mesh.py``), one command per process:

    python -m equss_tpu_torch.cli --config X.yaml \
        dist.coordinator=HOST:PORT dist.num_processes=N dist.process_id=R

(or ``EQUSS_COORDINATOR`` / ``EQUSS_NUM_PROCESSES`` / ``EQUSS_PROCESS_ID``
in the environment), or under a launcher that sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``torchrun``) with
``dist.auto=true``.  NCCL joins CUDA ranks, each on
``cuda:<local rank>``; gloo the CPU ones (``device=cpu``).  Each rank
reads its rows of every global batch of ``dataloader.*.batch_size``;
rank 0 picks the run directory, logs and writes the checkpoints.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from equss_tpu_torch.device import DeviceLike, resolve_device
from equss_tpu_torch.parallel import mesh

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
    """``(train_batches(epoch), val_batches(), res)``: the corpus's
    batches (``build_data``; an epoch's order from ``seed + epoch``), or
    synthetic ones under ``dataset.synthetic``, with the JAX package's
    seeds and counts, each process's rows of them; sets
    ``cfg['_iter_per_epoch']`` (the cosine schedules' horizon and the
    resume epoch)."""
    seed = cfg.get("seed", 0)
    bs = cfg["dataloader"]["train"]["batch_size"]
    vbs = cfg["dataloader"]["val"]["batch_size"]
    res = cfg["dataset"]["train"]["res"]
    if cfg.get("dataset", {}).get("synthetic"):
        from equss_tpu_torch.data.synthetic import synthetic_batches

        vres = cfg["dataset"]["val"]["res"]
        nb = cfg["dataset"].get("synthetic_batches", 16)
        ncls = cfg["num_classes"]

        part = dict(process_index=mesh.rank(), process_count=mesh.world())

        def train_batches(epoch: int):
            return synthetic_batches(seed + epoch, nb, bs, res, ncls, **part)

        def val_batches():
            return synthetic_batches(seed + 10_000, max(nb // 4, 1), vbs, vres, ncls,
                                     with_pos=False, **part)

        cfg["_iter_per_epoch"] = nb
        return train_batches, val_batches, res

    from equss_tpu_torch.data.pipeline import build_data

    train_data = build_data(cfg, "train", seed=seed)
    val_data = build_data(cfg, "val", seed=seed)

    def train_batches(epoch: int):
        return train_data.batches(bs, seed=seed + epoch)

    def val_batches():
        return val_data.batches(vbs, shuffle=False, drop_last=False)

    cfg["_iter_per_epoch"] = max(len(train_data) // bs, 1)
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


def _maybe_init_distributed(cfg: Dict[str, Any], device: DeviceLike) -> None:
    """Join the process group of a multi-process run from the ``dist.*``
    flags or the ``EQUSS_*`` environment (see the module docstring); a
    no-op for one process or a group already joined."""
    d = cfg.get("dist", {}) or {}
    if d.get("auto"):
        mesh.init_distributed(device=device, auto=True)
        return
    nproc = d.get("num_processes", os.environ.get("EQUSS_NUM_PROCESSES"))
    if not nproc or int(nproc) <= 1:
        return
    mesh.init_distributed(d.get("coordinator", os.environ.get("EQUSS_COORDINATOR")),
                          int(nproc), d.get("process_id", os.environ.get("EQUSS_PROCESS_ID")),
                          device=device)


@contextlib.contextmanager
def profiled(profile_dir: Optional[str], device: torch.device):
    """``torch.profiler`` over the body (host ops, and the CUDA kernels
    on a CUDA device) when ``profile_dir`` is set: its Chrome trace goes
    to ``<profile_dir>/trace_rank<r>.json`` on the way out, also when the
    body raises.  Without ``profile_dir`` a no-op."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_rank{mesh.rank()}.json")
        prof.export_chrome_trace(path)
        print(f"profile: {path}", flush=True)


def run(cfg: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The train job of a resolved config.  ``device`` (default
    ``cfg['device']``, else CUDA) is where the trainer runs.  Returns
    ``{"state": weights after the last step, "best": best validation}``,
    or for ``resume.mode: eval`` the final metrics under ``best``."""
    from equss_tpu_torch.core.checkpoint import CheckpointManager
    from equss_tpu_torch.core.logging import MetricsLogger
    from equss_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device if device is not None else cfg.get("device"))
    _maybe_init_distributed(cfg, dev)
    dev = mesh.local_device(dev)
    # every rank writes into rank 0's run directory
    save_dir = mesh.broadcast_object(_run_dir(cfg) if mesh.rank() == 0 else None,
                                     is_source=mesh.rank() == 0)
    logger = MetricsLogger(save_dir=save_dir, use_wandb=not cfg.get("debug", False),
                           wandb_cfg=_wandb_cfg(cfg), is_master=mesh.rank() == 0)
    logger.banner(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}"
                  f" (rank {mesh.rank()} of {mesh.world()})")

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
    with profiled(cfg.get("train", {}).get("profile_dir"), dev):
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


def run_crop_job(cfg: Dict[str, Any]) -> str:
    """The five-crop corpus of ``dataset.train`` (``crop_type``, default
    five; ``crop_ratio``, default 0.5) under its ``data_dir``."""
    from equss_tpu_torch.data.jobs import materialize_crops

    d = cfg["dataset"]["train"]
    out = materialize_crops(d["dataset_name"], d["data_dir"], mode="train",
                            crop_type=d.get("crop_type", "five"),
                            crop_ratio=d.get("crop_ratio", 0.5))
    print(f"cropped corpus written to {out}")
    return out


def run_pack_job(cfg: Dict[str, Any]) -> List[str]:
    """The packed decoded corpus of each split of ``dataset`` at
    ``default_pack_base``: one decode pass, after which an epoch reads
    memmap slices (``dataloader.<split>.pack: auto`` finds the pack).  A
    split whose corpus is missing or has no file list is skipped, and
    said so.  Returns the ``.bin`` paths written."""
    from equss_tpu_torch.data.cache import default_pack_base, pack_dataset
    from equss_tpu_torch.data.datasets import build_base_dataset

    written = []
    for mode in ("train", "val"):
        d = (cfg.get("dataset", {}) or {}).get(mode)
        if not d:
            continue
        try:
            ds = build_base_dataset(d["dataset_name"], mode, d["data_dir"], d["res"],
                                    d.get("crop_type"), d.get("crop_ratio", 0.5),
                                    d.get("loader_crop_type", "center"), cfg.get("seed", 0))
        except OSError as e:
            print(f"pack: {mode} corpus not found ({e}); skipped")
            continue
        if not hasattr(ds, "image_files"):
            print(f"pack: {mode} dataset has no file list; skipped")
            continue
        out = pack_dataset(ds, default_pack_base(d["data_dir"], d["dataset_name"], mode,
                                                 d.get("crop_type"), d["res"],
                                                 d.get("crop_ratio", 0.5)))
        print(f"packed {mode} corpus -> {out}")
        written.append(out)
    return written


def run_knn_job(cfg: Dict[str, Any], device: DeviceLike = None) -> str:
    """The kNN-positive cache of ``dataset.train``: the model of the
    config (``build_model``, weights from ``seed``, the DINO backbone of
    ``model.pretrained.pretrained_weights`` when given) on ``device``
    (default ``cfg['device']``, else CUDA), 30 neighbours per image by its
    frozen backbone's pooled features.  Returns the cache's path."""
    from equss_tpu_torch.data.jobs import precompute_knns
    from equss_tpu_torch.data.pipeline import UnSegData
    from equss_tpu_torch.models.registry import build_model

    dev = resolve_device(device if device is not None else cfg.get("device"))
    model = build_model(cfg, device=dev, seed=cfg.get("seed", 0))
    backbone = _load_backbone(cfg)
    if backbone is not None:
        model.backbone.load_state_dict(backbone)
    d = cfg["dataset"]["train"]
    # no positives here: this job makes the cache they are drawn from
    data = UnSegData(mode="train", data_dir=d["data_dir"], dataset_name=d["dataset_name"],
                     model_type=d.get("model_type", "vit_small"),
                     crop_type=d.get("crop_type"), crop_ratio=d.get("crop_ratio", 0.5),
                     loader_crop_type=d.get("loader_crop_type", "center"), res=d["res"],
                     pos_images=False, seed=cfg.get("seed", 0))
    # the name UnSegData looks for under <data_dir>/nns
    out_path = os.path.join(d["data_dir"], "nns",
                            f"nns_{d.get('model_type', 'vit_small')}_{d['dataset_name']}_train_"
                            f"{d.get('crop_type')}_224.npz")
    out = precompute_knns(model, data, out_path, k=30)
    print("->", out)
    return out


def run_export_job(cfg: Dict[str, Any], device: DeviceLike = None) -> str:
    """The predictor of ``resume.checkpoint`` (its latest checkpoint) as
    a ``torch.export`` artifact at ``export.path`` (default
    ``model.pt2``): input ``export.res`` (default ``dataset.val.res``)
    square, batch ``export.batch_size`` (default 1) symbolic unless
    ``export.symbolic_batch`` is ``off``, ImageNet normalisation inside
    unless ``export.normalize`` is false, traced on ``device`` (else
    ``cfg['device']``, CUDA) and serving the devices of
    ``export.platforms`` (a comma list, e.g. ``cuda,cpu``; default the
    traced one's).  Where ``export.platforms`` does not list that device,
    the trace runs on its first device.

        python -m equss_tpu_torch.cli export --config X.yaml \
            resume.checkpoint=<run>/ckpt export.path=model.pt2"""
    from equss_tpu_torch import serve
    from equss_tpu_torch.core.checkpoint import CheckpointManager
    from equss_tpu_torch.train.trainer import Trainer

    exp_cfg = cfg.get("export", {}) or {}
    ckpt_path = (cfg.get("resume", {}) or {}).get("checkpoint")
    out_path = exp_cfg.get("path", serve.DEFAULT_PATH)
    res = int(exp_cfg.get("res", cfg["dataset"]["val"]["res"]))
    platforms = serve.export_devices(exp_cfg.get("platforms"))
    want = device if device is not None else cfg.get("device")
    if platforms and torch.device(want if want is not None else "cuda").type not in platforms:
        want = platforms[0]
    dev = resolve_device(want)
    trainer = Trainer(cfg, device=dev)
    backbone = _load_backbone(cfg)
    if backbone is not None:
        trainer.model.backbone.load_state_dict(backbone)
    if ckpt_path:
        trainer.load_train_state(CheckpointManager(ckpt_path).restore(),
                                 resume_training=False)
    else:
        print("export: no resume.checkpoint given; exporting the freshly "
              "initialised model (smoke use only)")
    symbolic = exp_cfg.get("symbolic_batch", "auto")
    exported = serve.export_predictor(
        trainer, (res, res), batch_size=int(exp_cfg.get("batch_size", 1)),
        normalize=bool(exp_cfg.get("normalize", True)), platforms=platforms,
        # the override reader parses a bare `off` as False
        symbolic_batch={False: "off", True: "auto"}.get(symbolic, str(symbolic)))
    serve.save_predictor(exported, out_path)
    img = [n for n in exported.graph.nodes if n.op == "placeholder"][-1].meta["val"]
    print(f"-> {out_path} ({os.path.getsize(out_path)} bytes; input "
          f"{tuple(str(s) for s in img.shape)} on {dev})")
    return out_path


def main(argv: Optional[List[str]] = None):
    from equss_tpu_torch.core.config import prepare_config
    from equss_tpu_torch.core.random import set_seed

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    job = "train"
    if argv and argv[0] in JOBS:
        job = argv.pop(0)
    cfg, _ = prepare_config(argv)
    set_seed(cfg.get("seed", 0))
    if job == "crop":
        return run_crop_job(cfg)
    if job == "pack":
        return run_pack_job(cfg)
    if job == "knn":
        return run_knn_job(cfg)
    if job == "export":
        return run_export_job(cfg)
    return run(cfg)


if __name__ == "__main__":
    main()
