"""The whole user workflow, end to end, on a generated corpus.

    python3 -m equss_tpu_torch.tools.e2e_demo [--root DIR] [--keep]
        [--epochs 1] [--n-train 96] [--n-val 24] [--config X.yaml]
        [--override a.b=c] [--device cpu]

The port's counterpart of ``tools/e2e_demo.py``.  It builds a miniature
corpus in COCO-Stuff-27's directory layout and runs every job of the
workflow through ``equss_tpu_torch.cli``, as a user would:

  1. corpus     images/, annotations/ and curated/ lists (320 x 320 JPEG
                images of class-coloured 32 x 32 cells with noise, fine
                label PNGs over 15 fine classes spread across the coarse
                27), ``--n-train`` and ``--n-val`` images;
  2. crop       the five-crop corpus of the train split;
  3. knn        the kNN-positive cache, by the model's frozen backbone;
  4. pack       the packed decoded corpus of both splits;
  5. train      ``--epochs`` epochs of the config (default
                ``configs/pqgo_cocostuff27.yaml``: ViT-S/8 at 224^2, PQ
                64 x 256, seeded random weights), validating and keeping
                the best checkpoint, with the final evaluation but without
                its CRF, and PNGs of the final predictions;
  6. final_crf  the final evaluation of the best checkpoint again, with the
                dense CRF (``resume.mode=eval``, ``eval.final_crf=true``);
  7. export     that checkpoint as a ``torch.export`` artifact (input at
                ``dataset.val.res``, batch 4), read back with
                ``load_predictor`` and run on 4 images: predictions of the
                input's size.

Each stage prints its wall seconds on a JSON line; the last line sums it
up with the final metrics (with and without the CRF) and the artifact's
size.  ``--device`` adds ``device=<it>`` to every job (default: the CUDA
card).  The corpus and outputs live under ``--root`` (default a temporary
directory), removed at the end unless ``--keep``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import tempfile
import time

import numpy as np

from equss_tpu_torch.tools.common import add_config_args, add_device_arg, device_name, load_config


def build_corpus(root: str, n_train: int = 96, n_val: int = 24, res: int = 320,
                 seed: int = 0) -> None:
    """A miniature corpus in COCO-Stuff's directory layout; class-coded
    colour cells with noise, so that the probes move above chance."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    # fine ids whose fine -> coarse 27-class map spreads over several
    # coarse classes
    fine_ids = np.asarray([0, 2, 9, 16, 20, 60, 96, 105, 118, 123, 134, 147, 158, 168, 176],
                          np.int32)
    colors = rng.uniform(0.1, 0.9, (len(fine_ids), 3))
    for split, n in (("train2017", n_train), ("val2017", n_val)):
        for sub in ("images", "annotations", "curated"):
            os.makedirs(os.path.join(root, sub, split), exist_ok=True)
        ids = []
        for i in range(n):
            iid = f"e2e_{split[:-4]}_{i:06d}"
            ids.append(iid)
            grid = rng.randint(0, len(fine_ids), (res // 32, res // 32))
            lab = np.repeat(np.repeat(grid, 32, 0), 32, 1)
            img = colors[lab] + 0.06 * rng.randn(res, res, 3)
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, "images", split, iid + ".jpg"),
                                      quality=95)
            Image.fromarray(fine_ids[lab].astype(np.uint8)).save(
                os.path.join(root, "annotations", split, iid + ".png"))
        for list_name in ("Coco164kFull_Stuff_Coarse.txt", "Coco164kFew_Stuff_6.txt",
                          "Coco164kFull_Stuff_Coarse_7.txt"):
            with open(os.path.join(root, "curated", split, list_name), "w") as f:
                f.write("\n".join(ids))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="working directory (default: a temporary one)")
    ap.add_argument("--keep", action="store_true", help="keep the corpus and outputs")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--n-train", type=int, default=96)
    ap.add_argument("--n-val", type=int, default=24)
    add_config_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from equss_tpu_torch import resolve_device
    from equss_tpu_torch.cli import main as cli_main
    from equss_tpu_torch.serve import load_predictor

    dev = resolve_device(args.device)
    root = args.root or tempfile.mkdtemp(prefix="equss_e2e_")
    corpus = os.path.join(root, "cocostuff27")
    out_dir = os.path.join(root, "output")
    os.makedirs(out_dir, exist_ok=True)
    common = [f"data_dir={corpus}", f"save_dir={out_dir}", f"device={dev.type}",
              *args.override]
    base = ["--config", args.config, "--debug", *common]
    cfg = load_config(args.config, common)
    timings = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        ret = fn()
        timings[name] = time.perf_counter() - t0
        print(json.dumps({"stage": name, "seconds": timings[name]}), flush=True)
        return ret

    def export_and_check():
        ckpts = sorted(glob.glob(os.path.join(out_dir, "*", "ckpt")))
        if not ckpts:
            raise RuntimeError(f"no best checkpoint written under {out_dir}")
        art = os.path.join(out_dir, "model.pt2")
        cli_main(["export", *base, f"resume.checkpoint={ckpts[-1]}", f"export.path={art}",
                  "export.batch_size=4"])
        res = cfg["dataset"]["val"]["res"]
        out = load_predictor(art)(np.random.RandomState(0)
                                  .rand(4, res, res, 3).astype(np.float32))
        if any(tuple(v.shape) != (4, res, res) for v in out.values()):
            raise RuntimeError(f"artifact predictions {[v.shape for v in out.values()]}")
        return {"artifact_mb": os.path.getsize(art) / 2**20, "ckpts": len(ckpts)}

    try:
        stage("corpus", lambda: build_corpus(corpus, args.n_train, args.n_val))
        stage("crop", lambda: cli_main(["crop", *base]))
        stage("knn", lambda: cli_main(["knn", *base]))
        stage("pack", lambda: cli_main(["pack", *base]))
        result = stage("train", lambda: cli_main([
            *base, f"train.max_epochs={args.epochs}", "eval.final_crf=false",
            "is_visualize=true", f"visualize_path={os.path.join(out_dir, 'viz')}"]))
        ckpt = sorted(glob.glob(os.path.join(out_dir, "*", "ckpt")))[-1]
        final = stage("final_crf", lambda: cli_main([
            *base, f"resume.checkpoint={ckpt}", "resume.mode=eval", "eval.final_crf=true"]))
        export_info = stage("export", export_and_check)
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)

    summary = {"tool": "e2e_demo", "e2e": "ok", "device": device_name(dev), "timings_s": timings,
               "best": {k: float(v) for k, v in (result.get("best") or {}).items()
                        if isinstance(v, (int, float))},
               "final": {k: float(v) for k, v in final["best"].items()
                         if isinstance(v, (int, float))},
               "export": export_info}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
