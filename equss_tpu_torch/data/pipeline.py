"""Input pipeline: ``UnSegData`` and ``build_data``, batching with kNN
positives.

Counterpart of ``equss_tpu/data/pipeline.py``, and batch for batch the
same: a seeded epoch iterator collates numpy batches and, in train mode,
attaches each item's kNN positive, drawn from the precomputed top-k
neighbour cache (``jobs.precompute_knns``).  The index stream, the
per-item seeds, the positive draw, ``_collate`` and the producers /
workers / prefetch paths are the JAX package's, so that batches are
identical item for item whichever path decodes them.

Host parallelism:
  * ``num_workers`` threads decode the items of a batch concurrently
    (PIL's JPEG decode releases the GIL); per-item RandomState seeds
    keep crops and neighbour draws deterministic under any scheduling;
  * a background producer thread assembles up to ``prefetch`` batches
    ahead, overlapping host decode with the device step;
  * ``producers`` > 1 threads each materialise whole batches, delivered
    in order.

Batches whose loader crop is center or none can skip PIL: from a pack
(``data/cache.py``, memmap slices; ``pack: auto|on|off``) or through the
native C++ loader (``data/native_loader.py``, one batched decode call,
pixel for pixel as PIL; ``native: auto|on|off``).  ``auto`` takes the
native loader when its library builds and the corpus decodes, else PIL
(with a warning where a batch fails to decode); ``on`` raises instead.

Multi-process (``torch.distributed``), every process draws the same
global epoch order and per-item seeds and materialises only its
contiguous row slice of every global batch, a ragged batch padded by
wrap-around (DistributedSampler's duplication).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join
from typing import Any, Dict, Iterator, Optional

import numpy as np

from equss_tpu_torch.core.prefetch import threaded_prefetch
from equss_tpu_torch.data.datasets import build_base_dataset


class UnSegData:
    def __init__(
        self,
        mode: str,
        data_dir: str,
        dataset_name: str,
        model_type: str = "vit_small",
        crop_type: Optional[str] = None,
        crop_ratio: float = 0.5,
        loader_crop_type: str = "center",
        res: int = 224,
        pos_images: bool = False,
        num_neighbors: int = 7,
        seed: int = 0,
        nns_path: Optional[str] = None,
        num_workers: int = 0,
        native: str = "auto",
        pack: str = "auto",
        pack_path: Optional[str] = None,
        process_index: int = 0,
        process_count: int = 1,
        producers: int = 1,
        prefetch: int = 2,
    ) -> None:
        self.mode = mode
        self.pos_images = pos_images
        self.num_neighbors = num_neighbors
        self.num_workers = num_workers
        self.producers = producers
        self.prefetch = prefetch
        self.native = native
        if not (0 <= process_index < process_count):
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"process_count {process_count}")
        self.process_index = process_index
        self.process_count = process_count
        self.dataset = build_base_dataset(
            dataset_name, mode, data_dir, res, crop_type, crop_ratio,
            loader_crop_type, seed,
        )
        if pack != "off" and hasattr(self.dataset, "image_files"):
            from equss_tpu_torch.data.cache import PackedDataset, default_pack_base

            base_path = pack_path or default_pack_base(
                data_dir, dataset_name, mode, crop_type, res, crop_ratio)
            if os.path.exists(base_path + ".bin"):
                try:
                    self.dataset = PackedDataset(self.dataset, base_path)
                except Exception as e:
                    if pack == "on":
                        raise
                    import warnings
                    warnings.warn(
                        f"ignoring pack {base_path}.bin "
                        f"({type(e).__name__}: {e}); decoding from source "
                        f"files instead")
            elif pack == "on":
                raise FileNotFoundError(
                    f"dataloader pack=on but no pack at {base_path}.bin; "
                    f"run the 'pack' CLI job first")
        self.nns: Optional[np.ndarray] = None
        if pos_images:
            if nns_path is None:
                # the cache naming contract: every cocostuff variant
                # (cocostuff15/3/...) shares the cocostuff27 directory's
                # nns cache, a SIBLING of data_dir when the names differ;
                # data_dir/nns itself is the preferred location
                base = ("cocostuff27" if "cocostuff" in dataset_name
                        else dataset_name)
                fname = (f"nns_{model_type}_{dataset_name}_{mode}_"
                         f"{crop_type}_224.npz")
                candidates = [join(data_dir, "nns", fname)]
                norm = os.path.normpath(data_dir)
                if os.path.basename(norm) != base:
                    candidates.append(
                        join(os.path.dirname(norm), base, "nns", fname))
                nns_path = next(
                    (c for c in candidates if os.path.exists(c)),
                    candidates[0])
            if not os.path.exists(nns_path):
                raise FileNotFoundError(
                    f"could not find nn file {nns_path}; run the kNN "
                    f"job (equss_tpu_torch.data.jobs.precompute_knns)")
            self.nns = np.load(nns_path)["nns"]
            if len(self.dataset) != self.nns.shape[0]:
                raise ValueError(f"{nns_path} holds {self.nns.shape[0]} neighbour lists "
                                 f"for {len(self.dataset)} items")

    def __len__(self) -> int:
        return len(self.dataset)

    def item(self, index: int, rng: np.random.RandomState) -> Dict[str, Any]:
        ret = dict(self.dataset.get(index, rng)
                   if hasattr(self.dataset, "get") else self.dataset[index])
        # invalid-pixel mask, True where the label is ignore
        if "mask" not in ret and isinstance(ret.get("label"), np.ndarray):
            ret["mask"] = ret["label"] == -1
        if self.nns is not None:
            # the random 1..num_neighbors-th neighbour
            k = rng.randint(1, self.num_neighbors + 1)
            ind_pos = int(self.nns[index][k])
            pos = (self.dataset.get(ind_pos, rng)
                   if hasattr(self.dataset, "get") else self.dataset[ind_pos])
            ret["index_pos"] = ind_pos
            ret["img_pos"] = pos["img"]
            ret["label_pos"] = pos["label"]
            if isinstance(pos.get("label"), np.ndarray):
                ret["mask_pos"] = pos["label"] == -1
        return ret

    # -- batched fast paths (pack slice / native decode) ----------------

    def _fast_batch_kind(self) -> Optional[str]:
        """'pack' (memmap slices), 'native' (C++ batch decode) or None.

        Both fast paths require center/none loader crops (no per-pixel
        rng) on a file-backed dataset; a packed random-crop corpus still
        skips decode via ``PackedDataset.get`` inside the item() path.
        """
        from equss_tpu_torch.data.cache import PackedDataset

        ds = self.dataset
        simple_crop = getattr(ds, "crop_type", "?") in ("center", "none",
                                                        None)
        if isinstance(ds, PackedDataset):
            return "pack" if simple_crop else None
        if self.native == "off" or getattr(self, "_native_disabled", False):
            return None
        ok = (simple_crop and hasattr(ds, "image_files")
              and hasattr(ds, "label_files"))
        if ok:
            from equss_tpu_torch.data import native_loader
            ok = native_loader.available()
        if not ok and self.native == "on":
            raise RuntimeError(
                "dataloader native=on but the native loader does not apply "
                "here (needs a file-backed dataset with center/none loader "
                "crop and a buildable native/imageloader.so)")
        return "native" if ok else None

    def _draw_pos(self, idx_list, seeds):
        """k-th-neighbor picks — the SAME first RandomState draw item()
        would consume (center/none crops draw nothing before it)."""
        if self.nns is None:
            return []
        return [int(self.nns[i][np.random.RandomState(s).randint(
            1, self.num_neighbors + 1)]) for i, s in zip(idx_list, seeds)]

    def _assemble(self, idx_list, pos_list, imgs, labels) -> Dict[str, Any]:
        """item()/_collate batch contract from stacked arrays."""
        n = len(idx_list)
        batch: Dict[str, Any] = {
            "img": imgs[:n],
            "label": labels[:n],
            "img_path": [self.dataset.image_files[i] for i in idx_list],
            "index": np.asarray(idx_list, np.int32),
            "mask": labels[:n] == -1,
        }
        if self.nns is not None:
            batch["index_pos"] = np.asarray(pos_list, np.int32)
            batch["img_pos"] = imgs[n:]
            batch["label_pos"] = labels[n:]
            batch["mask_pos"] = labels[n:] == -1
        return batch

    def _native_batch(self, idxs, seeds) -> Dict[str, Any]:
        """One batched C++ decode call for the images (and positives) of
        a batch — bit-identical to the PIL item path (tested)."""
        from equss_tpu_torch.data.native_loader import (load_image_batch,
                                                  load_label_batch)
        ds = self.dataset
        mode = "center" if ds.crop_type == "center" else "none"
        idx_list = [int(i) for i in idxs]
        pos_list = self._draw_pos(idx_list, seeds)
        all_idx = idx_list + pos_list
        threads = max(1, self.num_workers)
        imgs = load_image_batch([ds.image_files[i] for i in all_idx],
                                ds.res, threads, mode)
        raw = load_label_batch([ds.label_files[i] for i in all_idx],
                               ds.res, threads, mode)
        # every remap_label is elementwise (LUT / shift / where), so one
        # batched apply equals the per-item loop
        labels = np.asarray(ds.remap_label(raw.astype(np.int32)), np.int32)
        return self._assemble(idx_list, pos_list, imgs, labels)

    def _pack_batch(self, idxs, seeds) -> Dict[str, Any]:
        """Memmap-slice batch from a ``PackedDataset`` — no codec at all."""
        from equss_tpu_torch.data.transforms import center_crop_np

        ds = self.dataset
        res = ds.res
        idx_list = [int(i) for i in idxs]
        pos_list = self._draw_pos(idx_list, seeds)
        all_idx = idx_list + pos_list
        m = len(all_idx)
        imgs = np.empty((m, res, res, 3), np.uint8)
        raw = np.empty((m, res, res), np.uint8)
        center = ds.crop_type == "center"
        for j, i in enumerate(all_idx):
            im, lb = ds.raw(i)
            if center:
                im, lb = center_crop_np(im, res), center_crop_np(lb, res)
            imgs[j], raw[j] = im, lb
        labels = np.asarray(ds.remap_label(raw.astype(np.int32)), np.int32)
        return self._assemble(idx_list, pos_list, imgs, labels)

    @staticmethod
    def _collate(items) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        for key in items[0]:
            vals = [it[key] for it in items]
            if isinstance(vals[0], np.ndarray):
                batch[key] = np.stack(vals)
            elif isinstance(vals[0], (int, np.integer)):
                batch[key] = np.asarray(vals, np.int32)
            else:
                batch[key] = vals              # e.g. paths
        return batch

    def _index_stream(self, batch_size, shuffle, seed, drop_last,
                      max_batches) -> Iterator:
        """Per-batch (idxs, seeds) pairs — the deterministic contract all
        decode paths and producer counts share."""
        rng = np.random.RandomState(seed)
        order = np.arange(len(self.dataset))
        if shuffle:
            rng.shuffle(order)
        n = len(order)
        stop = n - (n % batch_size) if drop_last else n
        count = 0
        for start in range(0, stop, batch_size):
            idxs = order[start: start + batch_size]
            # one deterministic seed per item, drawn IN ORDER from the
            # epoch rng, so crops/neighbor picks are reproducible no
            # matter how threads interleave (or which decode path runs)
            seeds = rng.randint(0, 2**31 - 1, size=len(idxs))
            if self.process_count > 1:
                # every process draws the identical global (idxs, seeds),
                # pads a ragged tail by wrap-around (DistributedSampler's
                # duplication) and materializes only its contiguous row
                # slice of the global batch
                rem = len(idxs) % self.process_count
                if rem:
                    pad = self.process_count - rem
                    idxs = np.concatenate([idxs, idxs[:pad]])
                    seeds = np.concatenate([seeds, seeds[:pad]])
                local = len(idxs) // self.process_count
                lo = self.process_index * local
                idxs = idxs[lo: lo + local]
                seeds = seeds[lo: lo + local]
            yield idxs, seeds
            count += 1
            if max_batches is not None and count >= max_batches:
                return

    def _materialize(self, idxs, seeds, fast, pool) -> Dict[str, Any]:
        """(idxs, seeds) -> collated batch via the active decode path.
        Thread-safe: pack slices a shared read-only memmap, native decode
        is GIL-free C++, and the PIL item path touches no shared state —
        so N producers may run this concurrently on different batches."""
        if fast == "pack":
            return self._pack_batch(idxs, seeds)
        if fast == "native" and not getattr(self, "_native_disabled", False):
            try:
                return self._native_batch(idxs, seeds)
            except Exception as e:
                if self.native == "on":
                    raise
                # e.g. a format the C++ decoders reject: fall back
                # to PIL permanently for this pipeline — loudly, so
                # the throughput drop is attributable
                import warnings
                warnings.warn(
                    f"native batch decode failed "
                    f"({type(e).__name__}: {e}); falling back to PIL "
                    f"for the rest of this pipeline")
                self._native_disabled = True
        fn = lambda args: self.item(          # noqa: E731
            int(args[0]), np.random.RandomState(args[1]))
        pairs = list(zip(idxs, seeds))
        items = list(pool.map(fn, pairs)) if pool is not None \
            else [fn(p) for p in pairs]
        return self._collate(items)

    def _epoch_batches(self, batch_size, shuffle, seed, drop_last,
                       max_batches, pool, fast: Optional[str] = None,
                       ) -> Iterator[Dict[str, np.ndarray]]:
        for idxs, seeds in self._index_stream(batch_size, shuffle, seed,
                                              drop_last, max_batches):
            yield self._materialize(idxs, seeds, fast, pool)

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: Optional[bool] = None,
        seed: int = 0,
        drop_last: Optional[bool] = None,
        max_batches: Optional[int] = None,
        num_workers: Optional[int] = None,
        prefetch: Optional[int] = None,
        producers: Optional[int] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Epoch iterator of collated numpy batches; with num_workers > 0
        decode runs in a thread pool and a producer thread keeps
        ``prefetch`` batches ready (the DataLoader workers' place).
        With producers > 1, N sharded-range producer
        threads each materialize WHOLE batches concurrently (in-order
        delivery) — this is how the pack reader scales past one core."""
        shuffle = (self.mode == "train") if shuffle is None else shuffle
        drop_last = shuffle if drop_last is None else drop_last
        workers = self.num_workers if num_workers is None else num_workers
        prefetch = self.prefetch if prefetch is None else prefetch
        producers = self.producers if producers is None else producers
        fast = self._fast_batch_kind()

        if producers > 1:
            from equss_tpu_torch.core.prefetch import ordered_parallel_map

            # per-batch item threads compose badly with batch producers;
            # the producers ARE the parallelism (each one runs the whole
            # batch materialization: memmap slice / C++ decode / PIL loop)
            stream = self._index_stream(batch_size, shuffle, seed,
                                        drop_last, max_batches)
            yield from ordered_parallel_map(
                lambda a: self._materialize(a[0], a[1], fast, None),
                stream, workers=producers, depth=max(prefetch, 1))
            return

        if workers <= 0 and fast is None:
            yield from self._epoch_batches(batch_size, shuffle, seed,
                                           drop_last, max_batches, None)
            return

        # pack slicing is near-free and native decode releases the GIL
        # entirely, so the producer thread overlaps with the device step
        # even on one core (unlike PIL decode threads, which ping-pong
        # the GIL there)
        if workers <= 0:
            gen = self._epoch_batches(batch_size, shuffle, seed, drop_last,
                                      max_batches, None, fast)
            yield from threaded_prefetch(gen, depth=max(prefetch, 1))
            return

        with ThreadPoolExecutor(max_workers=workers) as pool:
            gen = self._epoch_batches(batch_size, shuffle, seed, drop_last,
                                      max_batches, pool, fast)
            yield from threaded_prefetch(gen, depth=max(prefetch, 1))


def build_data(cfg: Dict[str, Any], mode: str, seed: int = 0) -> UnSegData:
    """cfg['dataset'][mode] -> UnSegData; cfg['dataloader'][mode] sets
    ``num_workers`` (decode threads), ``producers``, ``prefetch``,
    ``native``, ``pack`` and ``pack_path``.  In a process group
    (``torch.distributed`` initialised) each process takes the rows of
    its rank (``get_rank()`` of ``get_world_size()``), else all rows.
    The pipeline is host work: its batches are numpy arrays, which the
    trainer copies to its device."""
    import torch.distributed as dist

    in_group = dist.is_available() and dist.is_initialized()
    d = cfg["dataset"][mode]
    # decode threads only help with spare cores: on a one-core host they
    # contend for the GIL with the thread that feeds the device
    cpus = os.cpu_count() or 1
    dl_cfg = (cfg.get("dataloader", {}).get(mode, {}) or {})
    workers = dl_cfg.get("num_workers",
                         min(8, cpus - 1) if cpus > 1 else 0)
    # producers: whole-batch reader threads (the pack and native paths'
    # scaling lever); default 1, opt in per host-core budget
    producers = int(dl_cfg.get("producers", 1))
    prefetch = int(dl_cfg.get("prefetch", 2))
    return UnSegData(
        num_workers=workers,
        producers=producers,
        prefetch=prefetch,
        process_index=dist.get_rank() if in_group else 0,
        process_count=dist.get_world_size() if in_group else 1,
        native=str(dl_cfg.get("native", "auto")),
        pack=str(dl_cfg.get("pack", "auto")),
        pack_path=dl_cfg.get("pack_path"),
        mode=mode,
        data_dir=d["data_dir"],
        dataset_name=d["dataset_name"],
        model_type=d.get("model_type", "vit_small"),
        crop_type=d.get("crop_type"),
        crop_ratio=d.get("crop_ratio", 0.5),
        loader_crop_type=d.get("loader_crop_type", "center"),
        res=d["res"],
        pos_images=(mode == "train"),
        num_neighbors=d.get("num_neighbors", 7) if mode == "train" else -1,
        seed=seed,
        nns_path=d.get("nns_path"),
    )
