"""Train-loop input-pipeline benchmark: img/s of the real training loop by
decode path.

    python3 -m equss_tpu_torch.tools.bench_pipeline [--corpus DIR] [--n 512]
        [--epochs 3] [--batch 16] [--res 224] [--paths pil,native,pack]
        [--config X.yaml] [--override a.b=c] [--device cpu]

The port's counterpart of ``tools/bench_pipeline.py``.  It measures the
images per second of the whole train loop (host decode -> the transfer
thread of ``parallel/mesh.py::device_prefetch`` -> ``Trainer.train_step``)
for each input path of ``data/pipeline.py``:

  pil     per-item PIL decode;
  native  the batched C++ decode (``data/native_loader.py``; raises where
          its library does not build, as on a machine without libjpeg's
          and libpng's headers);
  pack    the packed decoded corpus (``data/cache.py``), built on first use.

The corpus is a generated five-crop-layout fixture (multi-octave-noise
320 x 240 JPEGs, uint8 label PNGs, 64 unique images rotated by symlink up
to ``--n``, a kNN cache), built in ``--corpus`` or, without it, in a
temporary directory removed at the end.  Real photos decode about twice
as slowly: compare the paths' ratios, not their absolute rates.  Each
epoch ends in ``torch.cuda.synchronize()``; with more than one epoch the
first (warm-up) is not counted.  Prints one line per epoch and one JSON
line with the best rate of each path and the megabytes a step that the
transfer thread copied to the device (``h2d_bytes``, ``core/trace.py``;
0 with ``--device cpu``, where the batches stay on the host).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from equss_tpu_torch.device import synchronize
from equss_tpu_torch.tools.common import (
    add_config_args,
    add_device_arg,
    device_name,
    load_config,
)


def build_fixture(root: str, n: int) -> None:
    """The five-crop corpus layout under ``root`` with ``n`` train items
    and their kNN cache (7 neighbours each)."""
    from PIL import Image

    crop_root = os.path.join(root, "cropped", "cocostuff27_five_crop_0.5")
    img_dir = os.path.join(crop_root, "img", "train")
    lbl_dir = os.path.join(crop_root, "label", "train")
    if os.path.exists(os.path.join(img_dir, f"{n - 1}.jpg")):
        return
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    n_unique = min(n, 64)
    for i in range(n_unique):
        h, w = 240, 320
        img = np.zeros((h, w, 3))
        for s in (8, 32, 128):      # multi-octave noise, near natural statistics
            img += np.kron(rng.rand(h // s + 1, w // s + 1, 3), np.ones((s, s, 1)))[:h, :w]
        img += 0.35 * rng.rand(h, w, 3)
        img = 255 * (img - img.min()) / (img.max() - img.min())
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(img_dir, f"{i}.jpg"),
                                                   quality=75)
        Image.fromarray(rng.randint(0, 28, (h, w)).astype(np.uint8)).save(
            os.path.join(lbl_dir, f"{i}.png"))
    for i in range(n_unique, n):    # rotated by symlink: each is decoded again
        os.symlink(os.path.join(img_dir, f"{i % n_unique}.jpg"),
                   os.path.join(img_dir, f"{i}.jpg"))
        os.symlink(os.path.join(lbl_dir, f"{i % n_unique}.png"),
                   os.path.join(lbl_dir, f"{i}.png"))
    nns_dir = os.path.join(root, "nns")
    os.makedirs(nns_dir, exist_ok=True)
    nns = np.stack([np.concatenate([[i], rng.choice(n, 7)]) for i in range(n)])
    np.savez(os.path.join(nns_dir, "nns_vit_small_cocostuff27_train_five_224.npz"), nns=nns)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", default=None,
                    help="fixture directory (default: a temporary one, removed after)")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--paths", default="pil,native,pack")
    add_config_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.n < args.batch:
        raise SystemExit(f"--n {args.n} < --batch {args.batch}: the train loop would "
                         f"yield no (drop_last) batch")

    from equss_tpu_torch import resolve_device
    from equss_tpu_torch.core import trace
    from equss_tpu_torch.data.cache import default_pack_base, pack_dataset
    from equss_tpu_torch.data.pipeline import UnSegData
    from equss_tpu_torch.parallel.mesh import device_prefetch
    from equss_tpu_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    corpus = args.corpus or tempfile.mkdtemp(prefix="equss_pipe_bench_")
    try:
        build_fixture(corpus, args.n)
        cfg = load_config(args.config, [f"data_dir={corpus}",
                                        f"dataloader.train.batch_size={args.batch}"]
                          + args.override)
        cfg["_iter_per_epoch"] = args.n // args.batch
        trainer = Trainer(cfg, device=dev)

        def pipe(**kw):
            return UnSegData("train", corpus, "cocostuff27", crop_type="five", res=args.res,
                             pos_images=True, num_neighbors=7, num_workers=0, **kw)

        def run_epochs(data, tag):
            rates, steps, h2d = [], 0, trace.counts().get("h2d_bytes", 0)
            for epoch in range(args.epochs):
                t0 = time.perf_counter()
                count = 0
                for batch in device_prefetch(data.batches(args.batch, seed=epoch), dev):
                    trainer.train_step(batch)
                    count += args.batch
                    steps += 1
                synchronize(dev)
                dt = time.perf_counter() - t0
                rates.append(count / dt)
                print(f"  {tag} epoch {epoch}: {count / dt:.1f} img/s ({count} imgs, "
                      f"{dt:.1f}s)", flush=True)
            h2d_mb[tag] = (trace.counts().get("h2d_bytes", 0) - h2d) / 1e6 / steps
            return max(rates[1:]) if len(rates) > 1 else rates[0]

        results, h2d_mb, pack_build_s = {}, {}, None
        for tag in args.paths.split(","):
            if tag == "pil":
                data = pipe(native="off", pack="off")
            elif tag == "native":
                data = pipe(native="on", pack="off")
            elif tag == "pack":
                base = default_pack_base(corpus, "cocostuff27", "train", "five", args.res)
                if not os.path.exists(base + ".bin"):
                    t0 = time.perf_counter()
                    pack_dataset(pipe(pack="off").dataset, base, log_every=0)
                    pack_build_s = time.perf_counter() - t0
                data = pipe(pack="on")
            else:
                raise SystemExit(f"unknown path {tag}")
            kind = data._fast_batch_kind()
            if kind != (None if tag == "pil" else tag):
                raise RuntimeError(f"path {tag} reads through {kind}")
            results[tag] = run_epochs(data, tag)
    finally:
        if args.corpus is None:
            shutil.rmtree(corpus, ignore_errors=True)
    out = {"tool": "bench_pipeline", "device": device_name(dev), "n": args.n,
           "epochs": args.epochs, "batch": args.batch, "res": args.res,
           "img_per_sec": results, "h2d_mb_per_step": h2d_mb,
           "pack_build_seconds": pack_build_s}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
