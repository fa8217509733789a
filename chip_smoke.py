#!/usr/bin/env python3
"""Drive the PyTorch port of EQUSS (``equss_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing JSON lines on stdout:

1. device   the card, its power limit (nvidia-smi), TF32 off for matmuls
            and cuDNN;
2. build    nvcc builds every kernel of ``equss_tpu_torch/csrc`` into
            ``equss_tpu_torch/_build`` (full compiler log:
            ``equss_tpu_torch/_build/build.log``): registers, spills (none
            allowed), ptxas's wgmma serialization warnings (none allowed
            for attention), the wgmma and TMA instructions in the
            attention library's SASS and the tensor-core instructions in
            the PQ library's;
3. kernels  each kernel against its plain PyTorch version on the card at
            the main paths' shapes and a few more (for attention also a
            late row max, a NaN neighbour and ViT-B/8's train and valid
            shapes), with its time, the plain version's, one PyTorch
            library call's (a yardstick the port never calls) and the
            bound the card's peak rates set (for attention also the
            exponential unit's); ``pq_wide``: the PQ kernel's wide bodies
            at the VQ baseline's calls (M = 1, K = 256, d = 1024 at
            n = 12 800 and 100 352) and at every other config's quantizer
            outside the pqgo family at the n of its valid step (VAE's
            3 200 and 12 800, Contra's 51 200, where its 16 x 1024 x 32
            exact launch runs fused), both modes, fast rows with a second
            yardstick (a bf16 ``torch.baddbmm`` for the distances), each
            wide row with its launch (blocks, resident blocks per SM,
            dynamic shared memory, the exact body's codeword splits and
            whether it runs fused); then which fast and exact rows lose
            to a yardstick, and each exact row's launch;
4. main     serving: the ViT-S/8 224^2 bf16 -> head -> PQ 64x256 forward
            on raw uint8 requests at b = 1, 8 and 128 with seeded weights:
            launch counts (12 attention and 1 PQ per forward), ms per
            batch and img/s; a second configuration with exact PQ at b = 8
            and a profile of it (the narrow exact body's device ms and
            share of its f32 bound per launch in path, n = 6 272);
            the card's output held stage by stage against the same model
            run on the CPU on a small input; and the b = 128 forward with
            the LayerNorm kernels (``fused_ln``) beside the stock one;
5. train    the pqgo train step of ``configs/pqgo_cocostuff27.yaml``
            (written out below as ``PQGO_COCOSTUFF27``) at b = 16 on
            synthetic batches, in two configurations: ``kernel``
            (``vq.use_pallas: 1`` and ``fused_ln``: 12 attention, 1
            LayerNorm, 24 add + LayerNorm and 1 PQ launch per step) and
            ``stock`` (the preset as it is: 12 attention launches); then
            one step at b = 2 on the card against the same step on the CPU;
6. profile  device time by kernel and the device's busy share (torch
            profiler) of two serving forwards at b = 1 and b = 128, with
            and without ``fused_ln``, and of two train steps of each
            configuration; every kernel of the port is picked out with
            its device ms per launch in the path;
7. valid    ``Trainer.validate`` of both train configurations over 4
            synthetic batches of b = 8 at 320^2 (40 x 40 patches, 1601
            tokens, labels in [-1, 27)): the returned metrics, launch
            counts per valid step (12 attention and 1 PQ; ``kernel`` adds
            1 LayerNorm and 24 add + LayerNorm), the valid step's median
            ms and a profile of two valid steps; then one valid step at
            b = 2 on the card against the same on the CPU (indices >= 95%
            equal; z_q and predictions held where the indices agree;
            both confusion matrices printed); then the exact sub-run: the
            preset with ``model.vq.assign_precision: exact`` and
            ``use_pallas: 1`` (``AssignSTE``), 4 train steps at b = 16 and
            4 valid steps at b = 8, 320^2 (12 attention + 1 PQ launch per
            step), each with a profile that names the narrow exact body's
            device ms and share of its f32 bound per launch in path
            (n = 12 544 and 12 800);
8. fit      ``Trainer.fit`` of the preset for one epoch of 4 train steps
            at b = 16, validating every 2 steps and at the epoch's end
            on 2 batches of b = 8 at 320^2: the logged steps, the best
            result and the wall time;
9. crf      the dense CRF (``ops/crf.py``): on the card against the same
            call on the CPU (60 x 76, C = 27, 10 iterations); at 320^2 the
            bf16-message refinement against the f32-message one; the ms
            of one bilateral pass at 320^2, C = 27, beside its bounds;
10. cli     ``equss_tpu_torch.cli.run`` on the preset with synthetic data
            (4 train steps at b = 16, one val batch of b = 8 at 320^2,
            validation every 2 steps, checkpoints): the logged and saved
            steps, ``final_*`` and ``final_crf_*``, the final CRF
            evaluation's wall time and its launches per valid CRF step
            (12 attention, 1 PQ); then the same run resumed for
            evaluation only (``final_Cluster_mIoU`` and
            ``final_crf_Cluster_mIoU`` equal within 1e-6) and resumed for
            training from its step-2 checkpoint, without the final CRF
            (each logged loss within rtol 1e-3 of the uninterrupted run's;
            the largest difference of the final weights printed).
11. custom_op_ab  serving latency at b = 1 and 8 with the kernels as
            custom ops against plain ctypes wrappers
            (``equss_tpu_torch/tools/ctypes_ab.py``), in turns;
12. data    the own-data path on a miniature COCO-Stuff corpus written
            into a temporary directory (64 train and 16 val 480 x 640 JPEG
            images of flat colour cells, PNG labels with an ignore band):
            the ``crop`` job through ``cli.main`` (320 five-crops);
13. knn     the ``knn`` job through ``cli.main`` at 224^2, b = 32: 10
            feature batches and 120 attention launches at (32, 785,
            1152), every crop its own first neighbour; the pooled features
            card vs CPU on the first batch (mean relative error <= 2e-2),
            the top-k against ``torch.topk`` on the CPU over the card's
            features where neighbours are more than 1e-3 apart; wall and
            device-only rates;
14. data    the ``pack`` job (both splits): the first two batches of each
            split from the pack equal to those decoded from the files;
            the host pipeline's img/s by decode path (PIL, pack, and the
            native loader where its library builds; why not, where not);
15. train_files  ``cli.run`` on the corpus: 20 train steps at b = 16 with
            kNN positives, validation at 320^2, b = 8, no final CRF: the
            decode path that ran, logged steps, ``final_Cluster_mIoU``,
            launches per step, the step's median beside the synthetic one;
16. export  the ``export`` job from that run's checkpoint at 320^2, b = 8,
            pinned and symbolic: the graph's ``equss::`` ops, each artifact
            from ``load_predictor`` against the live predictor (>= 99.99%
            of pixels equal; b = 1 and 8 for the symbolic one), 12 + 1
            launches per request, the artifact in a process that imports
            nothing of the model, ms per b = 8 request artifact vs live.

17. vq      ``configs/vq_cocostuff27.yaml`` (the EMA VQ baseline) at full
            width: train steps at b = 16 (EMA state moved; ``jsd``,
            ``entropy``, ``vq-loss`` finite; 12 attention launches), a
            valid step at b = 8, 320^2 (12 attention + 1 wide PQ), the
            predictor at b = 128 (12 + 1), profiles; the same valid
            steps and predictor with ``model.vq.assign_precision: exact``
            (the JAX default: the exact wide body, its device ms and
            share of bound per launch in path); and a b = 2 train step
            card vs CPU, at the preset's codebook and at one of 256 of the
            CPU's own codes (end-to-end indices >= 95% equal on the pairs
            whose CPU minimum is untied, printed with the tied and untied
            shares);
18. stego   ``stego_cocostuff27`` (ViT-S/8) and ``stego_pascal`` (ViT-B/8 at
            b = 64, valid at b = 32) train and valid steps with 12
            attention launches each, and a b = 2 STEGO step card vs CPU;
19. baselines  ``cluster_baseline`` (probes on frozen features) and
            ``sl_cocostuff27`` (supervised) train steps and ``validate``;
20. cli     ``cli.run`` on ``stego_cocostuff27`` and ``vq_cocostuff27`` with
            synthetic data, launches counted, and the STEGO run's predictor
            exported, loaded and held against the live one;
21. variants  the first ``models/variants.py`` slice at its configs'
            widths and batches: ``pqgo_cls_cocostuff27`` and
            ``cluster_margin_cocostuff27`` (b = 16, valid b = 8),
            ``cluster_swav_cocostuff27`` (b = 64, valid b = 32) and
            ``res_cocostuff27`` (b = 16, valid b = 8), the photometric
            view drawn on the card in each step: 4 train steps after 2
            warm-up and ``validate`` over 2 batches of 320^2 after 2, the
            step medians, the loss terms per step, peak memory, launches
            per path (attention 36 per ``pqgocls`` step, 3 backbone
            passes, and 12 per ``cluster`` or ``res`` step; PQ 1 per
            ``pqgocls`` valid step, 0 per train step), ``swav_it`` and
            ``swav_queue_n`` advancing, ``club-enc-loss`` below
            ``club-enc-loss-first`` in every step, the EMA head nearer the
            student after a step; a profile of 2 train and 2 valid steps
            of each;
    The second slice in the same phase and with the same rows:
            ``unseg_cocostuff27`` (UnSeg, b = 16, valid b = 8; the
            decoder's BatchNorm mean moves), ``new_vq_cocostuff27``
            (NewVQ, b = 16 + the view, valid b = 8; ``info_nce-loss``
            finite and positive) and ``spq_cocostuff27`` (SPQ, b = 16 +
            the view, valid b = 8; ``jsd`` >= 0, the codebook moves);
            the valid steps of UnSeg and NewVQ launch the PQ kernel's
            wide bodies (exact at 1 x 2048 x 384, fast at 8 x 2048 x 64,
            n = 12 800), 1 launch per valid step, and their profiles name
            the body with its device ms per launch and share of bound in
            path (``wide_launches_in_path``);
    The last slice in the same phase and with the same rows:
            ``vae_cocostuff27`` (b = 16 + the view, valid b = 8;
            ``contra-loss-pos`` >= 0), ``info_cocostuff27`` (b = 128,
            valid b = 32; ``vq0-usage`` and ``vq1-usage`` finite),
            ``contra_cocostuff27`` (b = 64 + the view, valid b = 32; its
            first batch's k-means ``data_init`` timed, its parameters
            moving on every second step and its EMA codebooks on every
            step) and ``ema_cocostuff27`` (b = 16 + the view, valid
            b = 8; 24 attention launches per train step, the
            ``data_init`` bank, the queue and EMA head moving); the valid
            steps of VAE and Contra launch the wide exact body twice each,
            and their profiles give each launch's device ms, share of
            bound and ratio to the same body's isolated time at the same
            n (phase 3);
22. stage1  NewVQ with ``model.stage: 1`` (``n_kmeans`` 100,
            ``eval.output_type: feat``, InfoNCE off as stage 1 computes
            none): 2 train steps after 1 at b = 16 + the view, k-means
            (10 Lloyd steps from k-means++ seeds, k = 2048) over the
            25 088 feature pixels and the quantizer and decoder on the
            204 800 selected rows: step median, the k-means share of it,
            peak memory;
23. variants_reference  one step of each at b = 2, dropout off, on the
            card against the CPU from the same seeded weights, with the
            same view, InfoNCE negatives, STEGO samples and (stage 1, at
            ``n_kmeans`` 10) k-means draws (``reference_step``): each loss
            term within 5e-2 relative, the trainable gradients' cosine >=
            0.98, ``pqgocls``'s pseudo-labels >= 95% equal end to end;
            NewVQ's quantizer on the card's code >= 99.5% and its indices
            >= 95% equal end to end on the pairs whose CPU minimum is
            untied (bf16 distances at the initial codebook tie, as the
            VQ baseline's do); NewVQ again at a codebook of 2 048 of the
            CPU's own codes per subspace, where most minima are untied,
            with the codebook gradient split into one term per pair (the
            terms sum to autograd's gradient, and over the pairs both
            devices assign alike their cosine >= 0.98; norms and cosines
            of the pairs picked as codewords and of the others printed);
            the last slice's four families,
            their Gumbel, split, dropout and proxy draws fixed, and the
            ``data_init`` of Contra and EMAModel given the same k-means
            draws.
24. distributed  the data parallelism of ``equss_tpu_torch/parallel``,
            ranks spawned with ``torch.multiprocessing`` on a free
            localhost port (``phase_distributed``): one rank in an NCCL
            group against no group (bit-equal, both step medians, the
            gradient's all-reduce alone), two ranks at the global b = 16
            (gloo on the one card, NCCL on two cards where there are two:
            ranks bit-equal after every step, loss terms and first-step
            gradients against the one-process run), a vq step's EMA counts,
            and ``build_sharded_predict_fn`` against ``build_predict_fn``;
            then the variants across ranks: one NCCL rank against no
            group for ``cluster_swav``, ``contra`` and ``ema`` (bit-equal),
            every config of ``VARIANTS`` at its widths over two ranks at
            the global b = 4 against one process (ranks bit-equal, loss
            terms, first-step gradient cosines), the valid step of the
            wide PQ paths (``unseg``, ``new_vq``, ``vae``, ``contra``)
            across the ranks (predictions and each launch's PQ indices
            against one process) and NewVQ's stage 1 across the ranks
            (the selected rows and the losses).
25. rest    (run after 10, cli) the last single-device slice on the
            preset at full width: ``validate(visualize_to=...)`` at b = 8,
            320^2 (12 attention + 1 PQ launches a valid step, as without
            PNGs; 1 072 PNGs; the cluster and codeword PNGs read back as
            the remapped predictions and the upsampled ids; host seconds
            per batch); ``cli.run`` with ``train.profile_dir`` and
            ``is_visualize`` (the trace's size, its ``equss::`` ops and
            kernel events; the final evaluation's PNGs); the feature
            cache of 32 images at b = 32, 224^2 (12 attention launches;
            img/s with and without the compressed write) and the train
            step from cached features against the image step at b = 16;
            the ViT's ``want_attn`` / ``n_last`` forward at b = 8 (no
            attention launch; ``dense`` within the serving class) against
            the fused one, and ``ln_stats: bf16`` against f32 statistics
            at b = 128 (ms in turns, the features' relative error); the
            quantizer options (restart with dropout and the weighted sum
            on the preset, restart with dropout on ``vq_cocostuff27``'s
            EMA codebook) at b = 16 on the plain PQ route.
26. crf_compare  ``parity/crf_compare.py::run_crf_compare`` at the
            flagship's widths (the twin config with PQ 64 x 256, d = 16,
            27 classes: ViT-S/8 in f32, exact PQ), 20 train steps at b = 8,
            224^2, then 2 val batches: the metrics with no CRF, the exact
            mean field on the card and the host lattice, the two refined
            argmaxes' agreement (>= 0.9) and each refinement's ms per image
            and probe; the valid forwards' PQ launches (the narrow exact
            body, 1 a val batch);
27. tools   each tool of ``equss_tpu_torch/tools`` once through its
            ``main``: ``flops``, ``profile_forward`` (b = 128, 3 steps),
            ``bench_train_step`` (the kernel route, 1 window of 5 steps),
            ``bench_serving`` (b = 8), ``bench_pq_kernel`` (n = 100 352,
            fast and exact), ``bench_pipeline`` (64 items, 1 epoch, each
            decode path the card can run) and ``e2e_demo`` (1 epoch on 16
            train and 8 val images): one line per tool with its result,
            seconds and launches (the benchmarks' own bars held: launches
            per step or request, the artifacts' graph ops and pixels, the
            PQ index agreement).
The configurations of 17-23 are ``preset(name)``: the preset with the
changes of ``PRESET_CHANGES``, which the tests hold against ``configs/``.
In the kernels line each PQ row counts the launches of its own body's
paths (``row_path``): the narrow fast row the preset's bf16 paths, the
narrow exact row the preset's exact ones, the wide fast row the VQ
baseline's and NewVQ's, the wide exact row the exact VQ sub-run's and
UnSeg's.

Then the wall seconds of each phase and the total (``phase_seconds``), the
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``.  Any failed check exits non-zero without the ok line; without
CUDA it exits non-zero before doing anything.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

# the H100's peaks: the port's one set of figures, with their source
from equss_tpu_torch.tools.flops import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS
# the port's one profiler
from equss_tpu_torch.tools.profile_forward import device_profile, profile_serving, serving_config

REPO = os.path.dirname(os.path.abspath(__file__))
FAILURES: list = []
SM_CLOCK_MAX_MHZ = 0.0       # nvidia-smi's clocks.max.sm, read in phase 1

# configs/pqgo_cocostuff27.yaml as a dict, so the script needs no YAML
# reader; tests/test_torch_trainer.py holds it against the file
PQGO_COCOSTUFF27 = {
    "save_dir": "output",
    "wandb": {"project": "equss_tpu", "mode": "offline", "name": "pqgo_cocostuff27"},
    "seed": 10,
    "num_classes": 27,
    "dataset_name": "cocostuff27",
    "data_dir": "../Datasets/cocostuff27",
    "is_visualize": False,
    "visualize_path": "./visualize/pqgo",
    "model": {
        "name": "pqgo",
        "pretrained": {"model_type": "vit_small", "dino_patch_size": 8,
                       "freeze_backbone": True, "dropout": True, "drop_prob": 0.1,
                       "pretrained_weights": None, "precision": "bf16"},
        "vq": {"assign_precision": "bf16", "vq_type": "param", "num_codebooks": [256],
               "embed_dims": [1024], "beta": 0.25, "book": 1.0, "normalize": "l2",
               "use_restart": False, "use_split": False, "use_weighted_sum": False,
               "use_gumbel": False, "need_initialized": "uni", "pq_dropout": 0.0,
               "decay": 0.99, "eps": 1.0e-6, "num_pq": [64]},
    },
    "loss": {
        "stego_weight": 1.0, "vq_weight": 1.0,
        "stego": {"neg_inter_weight": 0.63, "pos_inter_weight": 0.25,
                  "pos_intra_weight": 0.67, "neg_inter_shift": 0.66,
                  "pos_inter_shift": 0.02, "pos_intra_shift": 0.08, "zero_clamp": True,
                  "pointwise": True, "stabilize": False, "feature_samples": 11,
                  "neg_samples": 5, "correlation_precision": "bf16"},
    },
    "dataset": {
        "train": {"data_dir": "${data_dir}", "dataset_name": "${dataset_name}",
                  "model_type": "${model.pretrained.model_type}", "crop_type": "five",
                  "crop_ratio": 0.5, "loader_crop_type": "center", "num_neighbors": 7,
                  "res": 224},
        "val": {"data_dir": "${data_dir}", "dataset_name": "${dataset_name}",
                "model_type": "${model.pretrained.model_type}", "crop_type": None,
                "loader_crop_type": "center", "res": 320},
    },
    "dataloader": {"train": {"batch_size": 16}, "val": {"batch_size": 8}},
    "optimizer": {"model": {"name": "adam", "lr": 3.0e-4, "weight_decay": 0.0},
                  "cluster": {"name": "adam", "lr": 3.0e-3},
                  "linear": {"name": "adam", "lr": 3.0e-3}},
    "scheduler": {"model": {"name": "constant"}, "cluster": {"name": "constant"},
                  "linear": {"name": "constant"}},
    "eval": {"output_type": "vq0", "extra_classes": 0, "probe_res": "feat",
             "final_crf": True},
    "train": {"max_epochs": 15, "print_interval_iters": 25, "valid_interval_iters": 75,
              "clip_grad": 10.0, "num_accum": 1},
}

_STEGO = {"model.name": "stego", "model.pretrained.dim": 70, "eval.output_type": "feat",
          "model.vq": None, "loss.vq_weight": None}
_CLUSTER = {"model.name": "cluster", "model.hidden_dim": 512, "model.enc_num_blocks": 1,
            "loss.stego": None, "loss.stego_weight": None, "loss.vq_weight": None,
            "loss.margin_weight": 0.1, "optimizer.model.name": "adamw",
            "eval.output_type": "feat"}
# the second variants slice's NewVQ and SPQ: a soft or hard 8 x 2048 x 64
# quantizer after an encoder to 512, InfoNCE between the views
_VARIANT_PQ = {"model.vq.embed_dims": [512], "model.vq.normalize": "none",
               "model.vq.num_codebooks": [2048], "model.vq.num_pq": [8], "loss.stego": None,
               "loss.stego_weight": None, "loss.info_nce_weight": 0.1,
               "loss.info_nce": {"normalize": "l2", "neg_sample": 10, "temperature": 1.0,
                                 "cal_type": "random"},
               "loss.jsd": {"temperature": 1.0}, "optimizer.model.name": "adamw"}
# the last variants slice's Info and Contra: 10 epochs of cosine
# schedules, adamw with weight decay 2, clipping at 1, valid at b = 32
_LONG_RUN = {"optimizer.model.name": "adamw", "optimizer.model.weight_decay": 2.0,
             "scheduler": {"model": {"name": "cos"}, "cluster": {"name": "cos"},
                           "linear": {"name": "cos"}},
             "dataloader.val.batch_size": 32, "train.max_epochs": 10,
             "train.valid_interval_iters": 100, "train.clip_grad": 1.0}
# the baselines' configs as changes to the preset (dotted key: value; None
# drops the key); tests/test_torch_baselines.py holds each against its
# YAML file
PRESET_CHANGES = {
    "vq_cocostuff27": {"model.vq.vq_type": "ema", "model.vq.normalize": "none",
                       "model.vq.need_initialized": "none", "model.vq.num_pq": [1],
                       "optimizer.model.name": "adamw", "optimizer.model.weight_decay": 1e-6},
    "stego_cocostuff27": _STEGO,
    "stego_potsdam": {**_STEGO, "num_classes": 3, "dataset_name": "potsdam",
                      "data_dir": "../Datasets/potsdam", "loss.stego.neg_inter_shift": 0.26,
                      "loss.stego.pos_inter_shift": 0.12, "loss.stego.pos_intra_shift": 0.21},
    "stego_pascal": {**_STEGO, "num_classes": 20, "dataset_name": "pascal",
                     "data_dir": "../Datasets/pascal", "model.pretrained.model_type": "vit_base",
                     "loss.stego.neg_inter_weight": 1.0, "loss.stego.pos_inter_weight": 1.0,
                     "loss.stego.pos_intra_weight": 1.0, "loss.stego.neg_inter_shift": 0.5,
                     "loss.stego.pos_inter_shift": 0.1, "loss.stego.pos_intra_shift": 0.13,
                     "dataset.train.crop_type": "none", "dataset.train.loader_crop_type": "none",
                     "dataset.val.crop_type": "none", "dataset.val.loader_crop_type": "none",
                     "dataloader.train.batch_size": 64, "dataloader.val.batch_size": 32,
                     "train.max_epochs": 100, "train.print_interval_iters": 10,
                     "train.valid_interval_iters": 20},
    "cluster_baseline": {"model.name": "probe", "model.vq": None, "loss": {},
                         "optimizer.model.name": "adamw", "eval.output_type": "feat",
                         "eval.final_crf": False, "train.max_epochs": 1},
    "sl_cocostuff27": {"model.name": "sl", "model.pretrained.dim": 70,
                       "model.vq.assign_precision": None, "loss": {},
                       "eval.output_type": "feat", "train.supervised": True},
    "pqgo_cls_cocostuff27": {"model.name": "pqgocls", "model.encoder": {"momentum": 0.996},
                             "loss.cls_weight": 0.3, "loss.mse_weight": 1.0},
    "cluster_margin_cocostuff27": {**_CLUSTER, "model.vq.assign_precision": None},
    "cluster_swav_cocostuff27": {
        **_CLUSTER, "model.vq": None, "visualize_path": "./visualize/swav",
        "optimizer.model.weight_decay": 1.0e-4, "loss.swav_weight": 1.0,
        "loss.info_nce_weight": 0.0,
        "loss.info_nce": {"neg_sample": 100, "temperature": 0.1, "normalize": "l2",
                          "cal_type": "cosine"},
        "loss.cluster": {"num_prototypes": 1024, "queue_start_iter": 150,
                         "queue_stack_iter": 5, "queue_len": 4096, "temperature": 0.1,
                         "eps": 0.03, "freeze_prototypes_niter": 100},
        "dataset.train": {"data_dir": "${data_dir}", "dataset_name": "${dataset_name}",
                          "model_type": "${model.pretrained.model_type}", "crop_type": None,
                          "crop_ratio": 0.5, "loader_crop_type": "center", "res": 224},
        "dataloader.train.batch_size": 64, "dataloader.val.batch_size": 32,
        "train.max_epochs": 10, "train.valid_interval_iters": 25, "train.clip_grad": 1.0},
    "res_cocostuff27": {
        "model.name": "res", "model.hidden_dim": 512, "model.vq.assign_precision": None,
        "loss.stego": None, "loss.stego_weight": None, "loss.vq_weight": None,
        "loss.recon_weight": 1.0, "loss.info_nce_weight": 0.1, "loss.club_weight": 0.1,
        "loss.club": {"mi_iter": 5, "clip_grad": 1.0},
        "loss.info_nce": {"normalize": "l2", "neg_sample": 10, "temperature": 1.0,
                          "cal_type": "random"},
        "optimizer.model.name": "adamw", "optimizer.model.weight_decay": 1.0e-4,
        "optimizer.club_enc": {"name": "adam", "lr": 3.0e-6, "weight_decay": 0.0},
        "eval.output_type": "feat"},
    "unseg_cocostuff27": {
        "model.name": "hihi", "model.hidden_dim": 384, "model.enc_num_blocks": 1,
        "model.dec_num_blocks": 3, "model.vq.assign_precision": None,
        "model.vq.embed_dims": [384], "model.vq.normalize": "none",
        "model.vq.num_codebooks": [2048], "model.vq.num_pq": 1, "loss.stego": None,
        "loss.stego_weight": None, "loss.recon_weight": 1.0,
        "loss.contra_weight": {"pos": 0.0, "neg": 0.0}, "optimizer.model.name": "adamw",
        "optimizer.model.weight_decay": 1.0e-6},
    "new_vq_cocostuff27": {**_VARIANT_PQ, "model.name": "new", "model.enc_num_blocks": 1,
                           "model.dec_num_blocks": 1, "loss.recon_weight": 1.0,
                           "loss.jsd_weight": 0.0},
    "spq_cocostuff27": {**_VARIANT_PQ, "model.name": "spq", "loss.vq_weight": None,
                        "loss.jsd_weight": 0.1},
    "vae_cocostuff27": {
        "model.name": "vae", "model.hidden_dim": 384, "model.vq.assign_precision": None,
        "model.vq.num_codebooks": [1024, 1024], "model.vq.embed_dims": [256, 256],
        "model.vq.normalize": "none", "model.vq.num_pq": 1, "loss.stego": None,
        "loss.stego_weight": None, "loss.recon_weight": 1.0,
        "loss.contra_weight": {"pos": 0.1, "neg": 0.001}, "optimizer.model.name": "adamw",
        "optimizer.model.weight_decay": 2.0, "eval.output_type": "vq1"},
    "info_cocostuff27": {
        **_LONG_RUN, "model.name": "info", "visualize_path": "./visualize/info",
        "model.pretrained.dropout": False,
        "model.vq": {"vq_type": "ema", "num_codebooks": [1024, 1024], "embed_dims": [384, 384],
                     "beta": 0.25, "normalize": "l2", "use_restart": False, "use_gumbel": True,
                     "decay": 0.99, "eps": 1.0e-5},
        "model.enc_num_blocks": 3, "model.dec_num_blocks": 3,
        "loss": {"recon_weight": 1.0, "vq_weight": 100.0},
        "dataloader.train.batch_size": 128},
    "contra_cocostuff27": {
        **_LONG_RUN, "model.name": "contra", "visualize_path": "./visualize/contra",
        "model.pretrained.dropout": False,
        "model.vq": {"vq_type": "ema", "num_codebooks": [1024, 1024], "embed_dims": [512, 512],
                     "beta": 0.25, "normalize": "l2", "use_restart": False, "use_split": True,
                     "use_weighted_sum": False, "use_gumbel": False,
                     "need_initialized": "kmeans", "pq_dropout": 0.0, "decay": 0.99,
                     "eps": 1.0e-5, "num_pq": [4, 16], "agg_type": "concat"},
        "model.hidden_dim": 384, "model.enc_num_blocks": 1, "model.dec_num_blocks": 3,
        "loss": {"recon_weight": 1.0, "vq_weight": 10.0,
                 "contra_weight": {"pos": 0.1, "neg": 0.01}},
        "dataloader.train.batch_size": 64, "train.num_accum": 2},
    "ema_cocostuff27": {
        "model.name": "ema", "model.vq.assign_precision": None, "model.hidden_dim": 70,
        "model.encoder": {"momentum": 0.996, "temperature": 0.1},
        "model.memory_bank": {"n_cluster": 27, "queue_size": 64, "num_support": 16,
                              "enqueue_k": 4},
        "loss": {"info_nce_weight": 0.5, "mse_weight": 1.0,
                 "info_nce": {"temperature": 0.5, "num_queries": 16, "num_neg": 64}},
        "eval.output_type": "feat"},
}


def preset(name: str) -> dict:
    """``configs/<name>.yaml`` as a dict: the preset with the changes of
    ``PRESET_CHANGES``."""
    cfg = with_overrides(PQGO_COCOSTUFF27, {"wandb.name": name, **PRESET_CHANGES[name]})
    for dotted, value in PRESET_CHANGES[name].items():
        if value is None:
            *path, last = dotted.split(".")
            node = cfg
            for key in path:
                node = node[key]
            del node[last]
    return cfg


# the kernels each driven path must launch, per forward or per step
SERVE_KERNELS = {"attention_qkv": 12, "pq_assign": 1}
FUSED_LN_KERNELS = {"attention_qkv": 12, "layernorm": 1, "add_layernorm": 24, "pq_assign": 1}
STOCK_TRAIN_KERNELS = {"attention_qkv": 12}
# the port's kernels as the profiler names them
KERNEL_PICK = ("attention_kernel", "layernorm_kernel", "pq_fast", "pq_exact", "pq_wide")


def train_config(kind: str) -> dict:
    """``stock``: the preset as it is; ``kernel``: with ``vq.use_pallas: 1``,
    the PQ kernel's training route."""
    cfg = copy.deepcopy(PQGO_COCOSTUFF27)
    if kind == "kernel":
        cfg["model"]["vq"]["use_pallas"] = 1
    elif kind != "stock":
        raise ValueError(kind)
    return cfg


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> bool:
    if not cond:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)
    return cond


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict, iters: int, rounds: int = 3) -> dict:
    """Median device ms of each of ``fns`` (name: callable), timed with
    ``cuda_ms`` in turns (a, b, b, a, ``rounds`` times: six each for two)."""
    import statistics

    names = list(fns)
    times = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            times[k].append(cuda_ms(fns[k], iters=iters))
    return {k: statistics.median(v) for k, v in times.items()}


def bound_ms(flops: float, flop_rate: float, nbytes: float):
    t_ops, t_bytes = flops / flop_rate, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulp(x: torch.Tensor) -> float:
    return 2.0 ** (math.floor(math.log2(x.abs().max().item())) - 7)


def expected(per_unit: dict, units: int) -> dict:
    """Launch counts of every kernel wrapper for ``units`` forwards or
    steps of a path that launches ``per_unit`` of each."""
    from equss_tpu_torch import launch_counts

    return {k: per_unit.get(k, 0) * units for k in launch_counts()}


# ---------------------------------------------------------------- phases

def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card", file=sys.stderr)
        sys.exit(2)
    global SM_CLOCK_MAX_MHZ
    smi = nvidia_smi()
    print(smi, flush=True)
    # an idle card's clocks.sm reads low; the exponential bound takes the maximum
    SM_CLOCK_MAX_MHZ = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "sm_clock_max_mhz": SM_CLOCK_MAX_MHZ, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32})
    return kind


def phase_build() -> None:
    from equss_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = _build.build()
    seconds = time.perf_counter() - t0
    if log:
        with open(_build.BUILD_DIR / "build.log", "w") as f:
            for name, text in log.items():
                f.write(f"== {name}\n{text}\n")
    # ptxas -v: "Used N registers, ..." and "N bytes spill stores/loads"
    regs = {name: max(map(int, re.findall(r"Used (\d+) registers", text)), default=None)
            for name, text in log.items()}
    spills = {name: sum(map(int, re.findall(r"(\d+) bytes spill", text)))
              for name, text in log.items()}
    check(all(v == 0 for v in spills.values()), f"build: spills {spills}")
    # ptxas C7515: wgmma instructions serialized
    serialized = {name: text.count("C7515") for name, text in log.items()}
    check(serialized.get("attention_qkv", 0) == 0,
          "build: ptxas serialized the attention kernel's wgmma instructions")
    sass = library_sass("attention_qkv", ("HGMMA", "UTMALDG"))
    if sass.get("cuobjdump"):
        check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
              f"build: attention SASS lacks wgmma or TMA loads: {sass}")
    pq_sass = library_sass("pq_assign", ("HGMMA", "HMMA"))
    if pq_sass.get("cuobjdump"):
        check(pq_sass["HGMMA"] + pq_sass["HMMA"] > 0,
              f"build: PQ SASS lacks tensor-core instructions: {pq_sass}")
    emit({"phase": "build", "seconds": seconds, "built": sorted(log),
          "max_registers": regs, "spill_bytes": spills, "wgmma_serialized": serialized,
          "attention_sass": sass, "pq_assign_sass": pq_sass})


def library_sass(name: str, opcodes) -> dict:
    """Counts of the instructions ``opcodes`` in the SASS of the library of
    ``csrc/<name>.cu``, by ``cuobjdump -sass`` from the toolkit or from
    Triton's package; ``cuobjdump: null`` where neither has one.  An
    opcode counts where it starts an instruction (``HMMA`` does not count
    ``HGMMA``)."""
    import shutil
    from pathlib import Path

    from equss_tpu_torch.ops import _build

    tools = [str(Path(_build.nvcc_path()).parent / "cuobjdump"), shutil.which("cuobjdump")]
    try:
        import triton

        tools.append(str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
                         / "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if t and Path(t).is_file()), None)
    if tool is None:
        return {"cuobjdump": None}
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    return {"cuobjdump": tool,
            **{op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}}


def attention_input(B: int, N: int, H: int, hd: int, g, kind: str = "randn",
                    n_real: int = 0) -> torch.Tensor:
    """(B, N, 3, H, hd) bf16 q | k | v on the card, of the input kind
    ``kind`` (``equss_tpu_torch.ops.attention.attention_test_input``)."""
    from equss_tpu_torch.ops.attention import attention_test_input

    return attention_test_input(torch.randn((B, N, 3, H, hd), generator=g, device="cuda"),
                                kind, n_real)


def exp_bound_ms(exps: float) -> float:
    """The exponential unit's bound: 16 per clock per SM on 132 SMs at the
    card's maximum SM clock."""
    return 1e3 * exps / (16 * 132 * SM_CLOCK_MAX_MHZ * 1e6)


def attention_row(kernel: str, name: str, out, ref, items: int, fn, plain, library,
                  flops: float, nbytes: float, exps: float) -> dict:
    """Check ``out`` against ``ref`` on the first ``items`` batch items
    (finite, within 1 bf16 ulp of the output's scale), time the kernel
    and the library call in turns (``in_turns``, 10 launches a run) and
    the plain version, and return the row."""
    o, r = out[:items].float(), ref[:items].float()
    err = (o - r).abs().max().item()
    ulp = bf16_ulp(r)
    check(bool(torch.isfinite(o).all()) and err <= ulp,
          f"{kernel} {name}: max abs err {err} > 1 bf16 ulp {ulp}")
    bnd, by = bound_ms(flops, PEAK_BF16_FLOPS, nbytes)
    turns = in_turns({"kernel": fn, "library": library}, iters=10)
    return {"phase": "kernel", "kernel": kernel, "case": name, "max_abs_err": err,
            "tolerance": ulp, "items_checked": items,
            "ms": turns["kernel"], "plain_ms": cuda_ms(plain, iters=3),
            "library_ms": turns["library"],
            "bound_ms": bnd, "bound_by": by, "exp_bound_ms": exp_bound_ms(exps)}


def phase_attention(results: dict) -> None:
    """The packed attention kernel against its plain version at the main
    paths' shapes, ViT-B's width, the 320^2 validation length, a padded
    token stream (N > n_real), both late-max inputs and a NaN neighbour;
    tolerance one bf16 ulp of the output's scale.  Library yardstick:
    ``F.scaled_dot_product_attention`` over the real keys."""
    import torch.nn.functional as F

    from equss_tpu_torch.ops.attention import attention_qkv, attention_qkv_reference

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # name, B, N, H, n_real, input kind
        ("vit_s_224", 128, 785, 6, 785, "randn"),        # the serving path's shape
        ("vit_s_224_train", 32, 785, 6, 785, "randn"),   # the train step's [img; img_pos]
        ("vit_s_224_padded", 128, 896, 6, 785, "randn"),
        ("vit_b_224", 32, 785, 12, 785, "randn"),
        ("vit_b_224_train", 128, 785, 12, 785, "randn"),  # stego_pascal's step, b = 64
        ("vit_b_320_valid", 32, 1601, 12, 1601, "randn"),  # its valid step, b = 32
        ("vit_s_320", 32, 1601, 6, 1601, "randn"),       # cluster_swav's valid step, b = 32
        ("vit_s_224_pqgocls", 16, 785, 6, 785, "randn"),  # each of pqgocls's 3 passes
        ("vit_s_320_valid", 8, 1601, 6, 1601, "randn"),  # the valid step's shape
        ("late_max", 32, 785, 6, 785, "late_max"),
        ("late_max_near", 32, 785, 6, 785, "late_max_near"),
        ("nan_neighbour", 2, 785, 6, 785, "nan_neighbour"),
    ]
    for name, B, N, H, n_real, kind in cases:
        hd, C = 64, 64 * H
        scale = hd ** -0.5
        x = attention_input(B, N, H, hd, g, kind, n_real)
        qkv = x.reshape(B, N, 3 * C)
        q, k, v = x.permute(2, 0, 3, 1, 4)
        row = attention_row(
            "attention_qkv", name, attention_qkv(qkv, H, scale, n_real),
            attention_qkv_reference(qkv, H, scale, n_real),
            1 if kind == "nan_neighbour" else B,
            lambda: attention_qkv(qkv, H, scale, n_real),
            lambda: attention_qkv_reference(qkv, H, scale, n_real),
            lambda: F.scaled_dot_product_attention(
                q, k[:, :, :n_real], v[:, :, :n_real], scale=scale),
            4.0 * B * H * N * n_real * hd, 2.0 * B * N * (3 * C + C), 1.0 * B * H * N * n_real)
        emit({**row, "shape": [B, N, 3 * C], "heads": H, "n_real": n_real, "input": kind})
        results.setdefault("attention_qkv", row)
        del x, qkv, q, k, v
        torch.cuda.empty_cache()


def pq_row(name: str, n: int, M: int, K: int, d: int, mode: str, exact: bool, g) -> dict:
    """One PQ kernel case against its plain version: bars >= 99.99% of
    indices equal in exact mode, >= 99.5% in fast mode, indices in range,
    z_q the codeword at the kernel's own index bit for bit; the kernel's,
    the plain version's and the library yardstick's times (normalise +
    ``torch.cdist`` + ``argmin`` + gather) and the bound; in fast mode also
    the bf16 yardstick's (``library_bf16_call``: a bf16 ``torch.baddbmm``
    for the distances); for the wide bodies their launch (blocks,
    resident blocks per SM, dynamic shared memory, codeword splits)."""
    from equss_tpu_torch.ops.pq_assign import (
        kernel_body,
        pq_assign,
        pq_assign_reference,
        wide_config,
    )
    from equss_tpu_torch.tools.pq_ab import case_inputs, library_bf16_call, library_call

    z, cn, cb, zm, zs = case_inputs(n, M, K, d, mode, g)
    kw = dict(normalize=mode, z_mean=zm, z_std=zs, exact=exact)
    idx, zn, zq = pq_assign(z, cn, cb, **kw)
    idx_r, zn_r, zq_r = pq_assign_reference(z, cn, cb, **kw)
    torch.cuda.synchronize()
    same = idx == idx_r
    agree = same.float().mean().item()
    zn_err = (zn - zn_r).abs().max().item()
    zq_err_same = (zq - zq_r).abs()[same].max().item()
    src = cb if exact else cb.to(torch.bfloat16).float()
    zq_own = torch.equal(zq, src[torch.arange(M, device="cuda"), idx.long()])
    need = 0.9999 if exact else 0.995
    check(agree >= need, f"pq {name}: index agreement {agree} < {need}")
    check(zq_err_same == 0.0 and zq_own,
          f"pq {name}: z_q not the codeword at its index (err {zq_err_same})")
    check(bool(((idx >= 0) & (idx < K)).all()), f"pq {name}: index out of range")
    del idx, zn, zq, idx_r, zn_r, zq_r
    ms = cuda_ms(lambda: pq_assign(z, cn, cb, **kw), iters=10)
    plain = cuda_ms(lambda: pq_assign_reference(z, cn, cb, **kw), iters=3)
    lib = cuda_ms(lambda: library_call(z, cn, cb, mode, zm, zs), iters=3)
    extra = {}
    if not exact:
        extra["library_bf16_ms"] = cuda_ms(lambda: library_bf16_call(z, cn, cb, mode, zm, zs),
                                           iters=3)
    if kernel_body(d, K, exact) == "wide":
        extra["launch"] = wide_config(n, M, K, d, mode, exact)
    nbytes = 4.0 * (n * M * d + 2 * M * K * d + n * M + 2 * n * M * d
                    + (2 * M * d if zm is not None else 0))
    bnd, by = bound_ms(2.0 * n * M * K * d, PEAK_F32_FLOPS if exact else PEAK_BF16_FLOPS,
                       nbytes)
    row = {"phase": "kernel", "kernel": "pq_assign", "case": name,
           "body": kernel_body(d, K, exact), "n": n, "M": M, "K": K, "d": d,
           "normalize": mode, "exact": exact, "index_agreement": agree, "required": need,
           "max_abs_err": zn_err, "zq_err_where_equal": zq_err_same,
           "ms": ms, "plain_ms": plain, "library_ms": lib, **extra, "bound_ms": bnd,
           "bound_by": by, "share_of_bound": bnd / ms,
           "f32_ops_bound_ms": 1e3 * 2.0 * n * M * K * d / PEAK_F32_FLOPS}
    emit(row)
    del z, cb, cn
    torch.cuda.empty_cache()
    return row


def phase_pq(results: dict) -> None:
    """The PQ kernel's narrow bodies (M = 64, d = 16) against their plain
    version at the serving, train and valid calls in both modes (exact:
    the exact sub-run's calls, ``phase_pqgo_exact``, and the exact b = 8
    serving configuration's), the other normalisations, K = 512 (the fast
    mode's (value, index) minimum over many codeword tiles) and a ragged n
    (a last row tile of 5 rows); the bars and yardstick of ``pq_row``."""
    g = torch.Generator(device="cuda").manual_seed(1)
    n_bench = 128 * 28 * 28
    cases = [  # name, n, K, normalize, exact
        ("bench_fast_l2", n_bench, 256, "l2", False),   # the serving path's call
        ("train_fast_l2", 16 * 28 * 28, 256, "l2", False),   # the train step's
        ("valid_fast_l2", 8 * 40 * 40, 256, "l2", False),    # the valid step's
        ("bench_exact_l2", n_bench, 256, "l2", True),
        ("train_exact_l2", 16 * 28 * 28, 256, "l2", True),
        ("valid_exact_l2", 8 * 40 * 40, 256, "l2", True),
        ("serve8_exact_l2", 8 * 28 * 28, 256, "l2", True),
        ("z_norm_exact", 16384, 256, "z_norm", True),
        ("z_trainable_fast", 16384, 256, "z_trainable", False),
        ("k512_fast_l2", 16384, 512, "l2", False),
        ("train_fast_l2_ragged", 16 * 28 * 28 + 37, 256, "l2", False),
    ]
    for name, n, K, mode, exact in cases:
        row = pq_row(name, n, 64, K, 16, mode, exact, g)
        results.setdefault("pq_assign", row)
        if name == "train_exact_l2":
            # the kernels line's exact narrow row: the exact sub-run's train call
            results["pq_assign_exact"] = row


def pq_in_path(prof: dict, n: int, shape: tuple, exact: bool, body: str, launch: str,
               what: str) -> dict:
    """One PQ launch in a profile of ``calls`` calls of one launch each:
    the device ms per launch of its kernels (those whose name holds
    ``launch``) and the share of its bound at quantizer ``shape`` (M, K,
    d) and this n; the profile must name ``body``."""
    check(any(body in r["name"] for r in prof["picked"]), f"{what}: no {body} in the profile")
    ms = sum(r["ms"] for r in prof["picked"] if launch in r["name"]) / prof["calls"]
    M, K, d = shape
    bnd, by = bound_ms(2.0 * n * M * K * d, PEAK_F32_FLOPS if exact else PEAK_BF16_FLOPS,
                       4.0 * (3 * n * M * d + 2 * M * K * d + n * M))
    return {f"{launch}_ms_per_launch": ms, f"{launch}_bound_ms": bnd,
            f"{launch}_bound_by": by, f"{launch}_share_of_bound": bnd / ms if ms else None}


def narrow_exact_in_path(prof: dict, n: int, what: str) -> dict:
    """``pq_in_path`` for the narrow exact body (``pq_exact_kernel``) at
    the preset's quantizer, 64 x 256 x 16."""
    return pq_in_path(prof, n, (64, 256, 16), True, "pq_exact", "pq_exact", what)


# the quantizers of the configs outside the pqgo family (M, K, d,
# normalize) and the n of each of their calls: the valid step's at its
# config's valid batch (``PQ_VALID``, ``VARIANTS``; the VAE's top at
# 8 * 20 * 20, Contra's at 32 * 40 * 40) and the VQ baseline's b = 128
# serving forward
WIDE_PQ = [("vq", 1, 256, 1024, "none", (8 * 40 * 40, 128 * 28 * 28)),
           ("new_vq_spq", 8, 2048, 64, "none", (8 * 40 * 40,)),
           ("contra_4", 4, 1024, 128, "l2", (32 * 40 * 40,)),
           ("contra_16", 16, 1024, 32, "l2", (32 * 40 * 40,)),
           ("unseg", 1, 2048, 384, "none", (8 * 40 * 40,)),
           ("vae", 1, 1024, 256, "none", (8 * 20 * 20, 8 * 40 * 40))]


def phase_pq_wide(results: dict) -> None:
    """The PQ kernel's wide body against its plain version: each quantizer
    of the configs outside the pqgo family at each n its paths give it
    (``WIDE_PQ``), every one in both modes (``contra_16`` in fast mode is
    the narrow body's; in exact mode at Contra's n the body runs fused);
    the bars and yardstick of ``pq_row``."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name, M, K, d, mode, ns in WIDE_PQ:
        for n in ns:
            for exact in (False, True):
                tag = f"{name}_n{n}_{'exact' if exact else 'fast'}"
                rows.append(pq_row(tag, n, M, K, d, mode, exact, g))
    # each wide row by (M, K, d), mode and n: the in-path launches of the
    # variants' valid steps are held beside the same body at the same n
    results["pq_wide_isolated"] = {((r["M"], r["K"], r["d"]), r["exact"], r["n"]): r
                                   for r in rows if r["body"] == "wide"}
    # the kernels line's wide rows: the VQ valid step's call in both modes
    results["pq_assign_wide"] = rows[0]
    results["pq_assign_wide_exact"] = rows[1]
    check(all(r["body"] == "wide" for r in rows
              if not (r["case"].startswith("contra_16") and not r["exact"])),
          "pq_wide: a case left the wide body")
    fused = [r for r in rows if r["case"].startswith("contra_16") and r["exact"]]
    check(len(fused) == 1 and fused[0]["launch"]["fused"],
          "pq_wide: Contra's 16 x 1024 x 32 exact launch does not run fused")
    fast = [r for r in rows if not r["exact"] and r["body"] == "wide"]
    exact = [r for r in rows if r["exact"]]
    emit({"phase": "pq_wide_summary",
          "fast_rows_slower_than_library": [r["case"] for r in fast
                                            if r["ms"] >= r["library_ms"]],
          "fast_rows_slower_than_library_bf16": [r["case"] for r in fast
                                                 if r["ms"] >= r["library_bf16_ms"]],
          "exact_rows_slower_than_library": [r["case"] for r in exact
                                             if r["ms"] >= r["library_ms"]],
          "exact_launches": {r["case"]: {**r["launch"], "ms": r["ms"],
                                         "share_of_bound": r["share_of_bound"]}
                             for r in exact}})


def phase_layernorm(results: dict) -> None:
    """Both LayerNorm kernels against their plain versions at the train
    step's rows (32 * 785), the b = 128 serving rows, the b = 8 valid
    step's rows at 320^2 (8 * 1601) and ViT-B's width.
    Tolerance: at most 0.1% of elements differ, each by at most one bf16
    ulp of max(|out|, |bias|) (rsqrtf is not correctly rounded and the f32
    sums run in another order; where the affine terms cancel the output is
    far smaller than the terms that carry that error); the add kernel's
    bf16 sum bit-equal.  Library yardstick: ``F.layer_norm`` on the bf16
    rows with a bf16-cast affine (after ``x + y`` for the add kernel),
    which is not the same function: its statistics and affine are not
    those of the kernel.  Kernel and library are timed in turns (medians
    of six 20-launch runs); ``fits_l2_50mb`` says whether the bytes one
    launch moves could stay in the card's 50 MB L2 between launches."""
    import torch.nn.functional as F

    from equss_tpu_torch.ops.layernorm import (
        add_layernorm_reference,
        fused_add_layernorm,
        fused_layernorm,
        layernorm_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    eps = 1e-6
    for name, rows, C in (("train_vit_s", 32 * 785, 384), ("serve_vit_s", 128 * 785, 384),
                          ("valid_vit_s", 8 * 1601, 384), ("train_vit_b", 32 * 785, 768)):
        x = (3 * torch.randn((rows, C), generator=g, device="cuda") + 1).to(torch.bfloat16)
        y = torch.randn((rows, C), generator=g, device="cuda").to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(C, generator=g, device="cuda")
        bias = 0.1 * torch.randn(C, generator=g, device="cuda")
        sc16, bi16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        for kernel in ("layernorm", "add_layernorm"):
            if kernel == "layernorm":
                fn = lambda: fused_layernorm(x, scale, bias, eps)                  # noqa: E731
                plain = lambda: layernorm_reference(x, scale, bias, eps)           # noqa: E731
                lib = lambda: F.layer_norm(x, (C,), sc16, bi16, eps)               # noqa: E731
                out, ref, sum_equal = fn(), plain(), True
                nbytes, flops = 4.0 * rows * C + 8.0 * C, 8.0 * rows * C
            else:
                fn = lambda: fused_add_layernorm(x, y, scale, bias, eps)          # noqa: E731
                plain = lambda: add_layernorm_reference(x, y, scale, bias, eps)   # noqa: E731
                lib = lambda: F.layer_norm(x + y, (C,), sc16, bi16, eps)          # noqa: E731
                (s, out), (s_ref, ref) = fn(), plain()
                sum_equal = torch.equal(s, s_ref)
                nbytes, flops = 8.0 * rows * C + 8.0 * C, 9.0 * rows * C
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            mag = torch.maximum(ref.float().abs(), bias.abs().expand_as(diff))
            ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
            frac = (diff > 0).float().mean().item()
            err = diff.max().item()
            check(sum_equal and bool(torch.isfinite(out.float()).all())
                  and bool((diff <= ulp).all()) and frac <= 1e-3,
                  f"{kernel} {name}: {frac} of elements differ, max err {err}, "
                  f"beyond 1 ulp {int((diff > ulp).sum())}, sum equal {sum_equal}")
            bnd, by = bound_ms(flops, PEAK_F32_FLOPS, nbytes)
            turns = in_turns({"kernel": fn, "library": lib}, iters=20)
            row = {"phase": "kernel", "kernel": kernel, "case": name, "rows": rows, "C": C,
                   "max_abs_err": err, "frac_elements_differing": frac,
                   "tolerance": "1 bf16 ulp of max(|out|, |bias|) on <= 0.1% of elements",
                   "ms": turns["kernel"], "plain_ms": cuda_ms(plain, iters=5),
                   "library_ms": turns["library"],
                   "bytes_moved": nbytes, "fits_l2_50mb": nbytes <= 50e6,
                   "library": "F.layer_norm, bf16 affine" + (" after x + y" if kernel ==
                                                             "add_layernorm" else ""),
                   "bound_ms": bnd, "bound_by": by}
            emit(row)
            results.setdefault(kernel, row)
        del x, y
        torch.cuda.empty_cache()


def phase_fused_attention(results: dict) -> None:
    """The separate-q/k/v attention kernel against its plain version at
    the JAX package's test shapes, hd = 32, both late-max inputs, a NaN
    neighbour and the ViT-S b = 128 shape (the timing case); tolerance
    one bf16 ulp of the output's scale.  Library yardstick:
    ``F.scaled_dot_product_attention`` on the same tensors."""
    import torch.nn.functional as F

    from equss_tpu_torch.ops.attention import fused_attention, fused_attention_reference

    g = torch.Generator(device="cuda").manual_seed(4)
    for name, B, N, H, hd, kind in (
            ("jax_test_785", 2, 785, 6, 64, "randn"), ("jax_test_1601", 1, 1601, 2, 64, "randn"),
            ("jax_test_5", 1, 5, 2, 64, "randn"), ("hd32", 2, 128, 1, 32, "randn"),
            ("late_max", 2, 785, 6, 64, "late_max"), ("late_max_hd32", 2, 785, 2, 32, "late_max"),
            ("late_max_near", 2, 785, 6, 64, "late_max_near"),
            ("nan_neighbour", 2, 785, 6, 64, "nan_neighbour"),
            ("vit_s_224", 128, 785, 6, 64, "randn")):
        q, k, v = (t.contiguous() for t in attention_input(B, N, H, hd, g, kind, N).unbind(2))
        scale = hd ** -0.5
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = attention_row(
            "attention", name, fused_attention(q, k, v, scale=scale),
            fused_attention_reference(q, k, v, scale=scale),
            1 if kind == "nan_neighbour" else B,
            lambda: fused_attention(q, k, v, scale=scale),
            lambda: fused_attention_reference(q, k, v, scale=scale),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
            4.0 * B * H * N * N * hd, 8.0 * B * N * H * hd, 1.0 * B * H * N * N)
        emit({**row, "shape": [B, N, H, hd], "input": kind})
        if name == "vit_s_224":
            results["attention"] = row          # the timing case
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def main_config(precision: str = "bf16"):
    """bench.py's preset: ViT-S/8 at 224^2 in bf16 with attn_bf16, hidden
    1024, PQ 64 x 256 with l2 normalisation (``tools/profile_forward.py``)."""
    return serving_config("vit_small", precision)


def requests(batch: int, count: int, seed: int):
    """``count`` raw uint8 RGB requests of ``batch`` 224^2 images, on the host."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (batch, 224, 224, 3), generator=g, dtype=torch.uint8)
            for _ in range(count)]


def serve(model, reqs):
    """Answer each request: copy to the card, normalise, forward; the
    host clock runs from the copy to the synchronised result."""
    from equss_tpu_torch.data.transforms import normalize_images

    outs, times = [], []
    for req in reqs:
        t0 = time.perf_counter()
        out = model(normalize_images(req.to("cuda")))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    return outs, times


def check_outputs(out, batch: int, K: int, what: str) -> None:
    check(tuple(out["indices"].shape) == (batch, 28, 28, 64)
          and tuple(out["z_q"].shape) == (batch, 28, 28, 1024), f"{what}: shapes")
    check(bool(torch.isfinite(out["z_q"]).all()) and bool(torch.isfinite(out["feat"]).all()),
          f"{what}: non-finite output")
    idx = out["indices"]
    check(bool(((idx >= 0) & (idx < K)).all()), f"{what}: index outside [0, K)")


def phase_main(results: dict):
    """Serve the main configuration and the exact one; returns the main
    model and its configuration."""
    from equss_tpu_torch import EQUSS, launch_counts, reset_launch_counts
    from equss_tpu_torch.data.transforms import normalize_images

    cfg = main_config("bf16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = EQUSS(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    emit({"phase": "main_init", "seconds": time.perf_counter() - t0})
    depth = model.vit_cfg.depth

    plan = [(1, 2, 30), (8, 2, 30), (128, 2, 5)]     # batch, warm-up, timed
    reqs = {b: requests(b, w + n, seed=b) for b, w, n in plan}
    reset_launch_counts()
    forwards = 0
    for batch, warm, timed in plan:
        before = launch_counts()
        outs, times = serve(model, reqs[batch])
        forwards += warm + timed
        after = launch_counts()
        n_fwd = warm + timed
        check({k: after[k] - before[k] for k in after} == expected(SERVE_KERNELS, n_fwd),
              f"main b={batch}: launches {after} vs {before} for {n_fwd} forwards")
        for out in outs:
            check_outputs(out, batch, cfg.pq.num_codebook, f"main b={batch}")
        t = sorted(times[warm:])
        ms = 1e3 * sum(t) / len(t)
        emit({"phase": "main", "config": "bf16", "batch": batch, "forwards": n_fwd,
              "ms_per_batch_mean": ms, "ms_per_batch_min": 1e3 * t[0],
              "ms_per_batch_median": 1e3 * t[len(t) // 2],
              "img_per_s": batch * 1e3 / ms,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        del outs
    counts = launch_counts()
    check(counts == expected(SERVE_KERNELS, forwards),
          f"main path launches {counts} for {forwards} forwards")
    check(all(counts[k] > 0 for k in SERVE_KERNELS), f"a kernel never launched: {counts}")
    results["launches"]["serve"] = counts
    emit({"phase": "main_launches", "forwards": forwards, **counts})

    # second configuration: exact PQ at b = 8
    model_x = EQUSS(main_config("exact"), device="cuda", seed=0)
    warm, timed = 2, 30
    reset_launch_counts()
    outs, times = serve(model_x, requests(8, warm + timed, seed=80))
    counts_x = launch_counts()
    check(counts_x == expected(SERVE_KERNELS, warm + timed),
          f"exact config launches {counts_x}")
    for out in outs:
        check_outputs(out, 8, cfg.pq.num_codebook, "exact b=8")
    t = sorted(times[warm:])
    emit({"phase": "main", "config": "exact", "batch": 8, "forwards": warm + timed,
          "ms_per_batch_mean": 1e3 * sum(t) / len(t),
          "ms_per_batch_median": 1e3 * t[len(t) // 2], "img_per_s": 8 * len(t) / sum(t),
          **{f"launches_{k}": v for k, v in counts_x.items()}})
    results["launches"]["serve_exact"] = counts_x
    img = normalize_images(requests(8, 1, seed=81)[0].to("cuda"))
    prof = device_profile(lambda: model_x(img), 2, pick=KERNEL_PICK)
    emit({"phase": "profile", "what": "serve_exact", "batch": 8, "forwards": 2, **prof,
          **narrow_exact_in_path(prof, 8 * 28 * 28, "serve exact b=8")})
    del model_x, outs

    phase_reference(model, cfg)
    return model, cfg


def phase_reference(model, cfg) -> None:
    """The card's forward against the same seeded model on the CPU (plain
    kernel versions), stage by stage, on 2 images:
    * dense features: bf16 through 12 layers, rounded in another order on
      each side: mean relative error <= 2e-2, max abs error <= 0.25;
    * head (f32) on the card's own features: max error <= 1e-4 relative;
    * PQ (bf16 fast mode) on the card's own code: >= 99.5% indices equal;
    * end to end: >= 95% indices equal."""
    from equss_tpu_torch import EQUSS
    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.ops.quantizer import pq_forward

    ref_cfg = dataclasses.replace(cfg, pq=dataclasses.replace(cfg.pq, use_pallas=True))
    ref = EQUSS(ref_cfg, device="cpu", seed=0)
    img = normalize_images(requests(2, 1, seed=7)[0])
    out_g = model(img.to("cuda"))
    with torch.no_grad():
        feat_c = ref.features(img)
        feat_g = out_g["feat"].cpu()
        code_c = ref.encode(feat_g)
        _, idx_c, _, _ = pq_forward(out_g["code"].cpu(), dict(ref.pq),
                                    ref.pq_state.as_dict(), ref_cfg.pq)
    end_c = ref(img)
    feat_rel = ((feat_g - feat_c).abs().mean() / feat_c.abs().mean()).item()
    feat_max = (feat_g - feat_c).abs().max().item()
    head_rel = ((out_g["code"].cpu() - code_c).abs().max() / code_c.abs().max()).item()
    pq_agree = (out_g["indices"].cpu() == idx_c).float().mean().item()
    e2e_agree = (out_g["indices"].cpu() == end_c["indices"]).float().mean().item()
    check(feat_rel <= 2e-2 and feat_max <= 0.25,
          f"reference: features rel {feat_rel} / max {feat_max}")
    check(head_rel <= 1e-4, f"reference: head rel err {head_rel}")
    check(pq_agree >= 0.995, f"reference: PQ index agreement {pq_agree}")
    check(e2e_agree >= 0.95, f"reference: end-to-end index agreement {e2e_agree}")
    emit({"phase": "reference_cpu", "batch": 2, "feat_mean_rel_err": feat_rel,
          "feat_max_abs_err": feat_max, "head_max_rel_err": head_rel,
          "pq_index_agreement": pq_agree, "end_to_end_index_agreement": e2e_agree})


def phase_profile(model) -> None:
    """Device time by kernel and the device's busy share over two
    serving forwards at b = 1 and at b = 128
    (``tools/profile_forward.py``)."""
    for batch in (1, 128):
        emit({"phase": "profile", "what": "serve", "batch": batch, "forwards": 2,
              **profile_serving(model, batch, 2, pick=KERNEL_PICK)})


def phase_serve_fused_ln(model, cfg, results: dict) -> None:
    """The b = 128 serving forward with the LayerNorm kernels (``fused_ln``)
    beside the stock one, same seeded weights, in turns (stock, fused,
    fused, stock); its features held against the stock forward's on the
    card in the bf16 class of the reference phase (mean relative error
    <= 2e-2, max abs error <= 0.25) and its indices >= 95% equal."""
    from equss_tpu_torch import EQUSS, launch_counts, reset_launch_counts
    from equss_tpu_torch.data.transforms import normalize_images

    fused = EQUSS(dataclasses.replace(cfg, fused_ln=True), device="cuda", seed=0)
    reqs = requests(128, 7, seed=1280)
    times = {"stock": [], "fused_ln": []}
    outs = {}
    for name in ("stock", "fused_ln", "fused_ln", "stock"):
        reset_launch_counts()
        o, t = serve(fused if name == "fused_ln" else model, reqs)
        counts = launch_counts()
        want = FUSED_LN_KERNELS if name == "fused_ln" else SERVE_KERNELS
        check(counts == expected(want, len(reqs)), f"serve {name}: launches {counts}")
        times[name] += t[2:]
        outs[name] = o[-1]
        if name == "fused_ln":
            results["launches"]["serve_fused_ln"] = counts
    a, b = outs["fused_ln"]["feat"], outs["stock"]["feat"]
    rel = ((a - b).abs().mean() / b.abs().mean()).item()
    mx = (a - b).abs().max().item()
    agree = (outs["fused_ln"]["indices"] == outs["stock"]["indices"]).float().mean().item()
    check(rel <= 2e-2 and mx <= 0.25 and agree >= 0.95,
          f"serve fused_ln vs stock: rel {rel} max {mx} indices {agree}")
    row = {"phase": "serve_fused_ln", "batch": 128, "requests_timed": len(times["stock"]),
           "feat_mean_rel_err": rel, "feat_max_abs_err": mx, "index_agreement": agree}
    for name, t in times.items():
        t = sorted(t)
        row[f"{name}_ms_median"] = 1e3 * t[len(t) // 2]
        row[f"{name}_ms_min"] = 1e3 * t[0]
    emit(row)
    img = normalize_images(reqs[0].to("cuda"))
    emit({"phase": "profile", "what": "serve_fused_ln", "batch": 128, "forwards": 2,
          **device_profile(lambda: fused(img), 2, pick=KERNEL_PICK)})


def train_model(kind: str, device: str = "cuda", dropout: bool = True, grid=None, **train):
    """(config, Trainer) of one train configuration, weights from seed 0;
    ``train`` overrides keys of its ``train`` section; ``grid`` the
    process's (data, model) grid."""
    from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig
    from equss_tpu_torch.train.trainer import Trainer

    cfg = train_config(kind)
    cfg["model"]["pretrained"]["dropout"] = dropout
    cfg["train"].update(train)
    mcfg = dataclasses.replace(EQUSSConfig.from_config(cfg), fused_ln=kind == "kernel")
    return cfg, Trainer(cfg, device=device, model=EQUSS(mcfg, device=device, seed=0),
                        mesh=grid)


def phase_train(results: dict) -> None:
    """The pqgo train step at b = 16 (+16 positives) on synthetic 224^2
    batches: ``kernel`` and ``stock``, each 3 warm-up and 20 timed steps
    (host clock to the synchronised end of the step, the batch's copy to
    the card included), exact launch counts per step, every loss finite,
    and a profile of two steps."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.data.synthetic import synthetic_batches

    warm, timed = 3, 20
    batches = list(synthetic_batches(0, warm + timed, 16, res=224, num_classes=27))
    for kind, per_step in (("kernel", FUSED_LN_KERNELS), ("stock", STOCK_TRAIN_KERNELS)):
        torch.cuda.reset_peak_memory_stats()
        _, tr = train_model(kind)
        times, metrics = [], []
        for i, batch in enumerate(batches):
            if i == warm:
                reset_launch_counts()
            t0 = time.perf_counter()
            metrics.append(tr.train_step(batch))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = launch_counts()
        results["launches"][f"train_{kind}"] = counts
        check(counts == expected(per_step, timed), f"train {kind}: launches {counts}")
        check(all(np.isfinite(v) for m in metrics for v in m.values())
              and not any(m["skipped"] for m in metrics), f"train {kind}: non-finite step")
        t = sorted(times[warm:])
        results[f"{kind}_step_ms_median"] = 1e3 * t[timed // 2]
        emit({"phase": "train", "config": kind, "batch": 16, "steps_timed": timed,
              "ms_per_step_median": 1e3 * t[timed // 2], "ms_per_step_min": 1e3 * t[0],
              "ms_per_step_mean": 1e3 * sum(t) / timed, "first_step_ms": 1e3 * times[0],
              "launches_per_step": {k: v / timed for k, v in counts.items()},
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              **{f"{k}_per_step": [m[k] for m in metrics]
                 for k in ("loss", "stego-loss", "vq-loss", "linear-loss", "cluster-loss")}})
        cycle = iter(batches * 2)
        emit({"phase": "profile", "what": f"train_{kind}", "batch": 16, "steps": 2,
              **device_profile(lambda: tr.train_step(next(cycle)), 2,
                               pick=KERNEL_PICK + ("index", "bmm", "Memcpy"))})
        del tr
        torch.cuda.empty_cache()


def stego_samples(batch: dict, seed: int, feature_samples: int = 11) -> dict:
    """``batch`` with STEGO's coordinates and permutations fixed from
    ``seed`` (the batch keys ``stego_coords1/2``, ``stego_perms``), so that
    two runs of a step draw the same samples."""
    rng = np.random.RandomState(seed)
    b = len(batch["img"])
    shape = (b, feature_samples, feature_samples, 2)
    return dict(batch, stego_coords1=rng.uniform(-1, 1, shape).astype(np.float32),
                stego_coords2=rng.uniform(-1, 1, shape).astype(np.float32),
                stego_perms=np.stack([rng.permutation(b) for _ in range(5)]).astype(np.int32))


def model_pq_cfg(model):
    """The ``PQConfig`` of a model with one quantizer: EQUSS's
    ``cfg.pq``, a variant's ``pq_cfg``."""
    return model.pq_cfg if hasattr(model, "pq_cfg") else model.cfg.pq


def minimum_ties(tr, code: torch.Tensor) -> tuple:
    """(tied share, untied mask) of the (pixel, subspace) pairs of ``code``
    under the CPU trainer ``tr``'s quantizer, in its own arithmetic: a pair
    is tied where its smallest distance is shared by more than one codeword
    (there the first index wins, whatever the inputs' last bits), and
    untied (mask (pixels, M), True) where the second-smallest distance is
    larger than the smallest by more than one bf16 ulp of the smallest."""
    from equss_tpu_torch.ops.pq_assign import normalize_vectors
    from equss_tpu_torch.ops.quantizer import pairwise_sqdist

    cfg = model_pq_cfg(tr.model)
    codebook = (tr.model.pq["codebook"] if cfg.vq_type == "param"
                else tr.model.pq_state.ema_weight).detach()
    zf = code.reshape(-1, cfg.num_pq, cfg.sub_dim)
    with torch.no_grad():
        d = pairwise_sqdist(normalize_vectors(zf, cfg.normalize),
                            normalize_vectors(codebook, cfg.normalize),
                            precision=cfg.assign_precision).float()
        tied = ((d == d.amin(-1, keepdim=True)).sum(-1) > 1).float().mean().item()
        two = d.topk(min(2, d.shape[-1]), dim=-1, largest=False).values
        if two.shape[-1] < 2:
            return tied, torch.ones(two.shape[:-1], dtype=torch.bool)
        exp = torch.frexp(two[..., 0]).exponent.float()       # |x| in [2^(e-1), 2^e)
        ulp = torch.where(two[..., 0] == 0, torch.zeros_like(exp), torch.exp2(exp - 8))
        return tied, two[..., 1] - two[..., 0] > ulp


LOSS_TERMS = ("loss", "stego-loss", "vq-loss", "linear-loss", "cluster-loss", "margin-loss",
              "swav-loss", "recon-loss", "info_nce-loss", "club-loss", "club-enc-loss",
              "mse-loss", "cls-loss", "contra-loss-pos", "contra-loss-neg")


def reference_step(make_trainer, batch: dict, grads: dict, what: str,
                   e2e_bar: bool = True, quantizer: bool = True,
                   indices: bool = True, reported: Optional[dict] = None) -> dict:
    """One training forward and backward of ``make_trainer(device)`` on the
    card and on the CPU (plain kernel versions) from the same seeded
    weights and batch; TF32 is off on the card (phase 1).  Bars: each loss
    term within 5e-2 relative, the cosine similarity of each gradient of
    ``grads`` (name: parameter-name prefix) >= 0.98, and where the model
    quantizes, the CPU's quantizer on the card's own code >= 99.5% of
    indices equal (the fast mode's class) and the end-to-end indices >= 95%
    equal (the serving reference's class): over all pairs with
    ``e2e_bar``, else over the pairs whose CPU minimum is untied
    (``minimum_ties``), printed beside the tied share and the untied share
    (an empty untied set holds nothing and says so).  ``quantizer=False``
    (a model whose indices are not of its ``code``: ``pqgocls``'s teacher)
    holds the end-to-end indices only; ``indices=False`` none (NewVQ's
    stage 1, whose indices are of the rows its k-means selects: their
    order within a centroid follows each side's f32 rounding).
    ``reported`` (name: prefix): gradients whose cosine is printed, not
    held.  Returns the row."""
    from equss_tpu_torch.ops.quantizer import pq_forward

    runs = {}
    everything = {**grads, **(reported or {})}
    for device in ("cuda", "cpu"):
        tr = make_trainer(device)
        metrics, out = tr.forward_backward(batch)
        flat = {name: torch.cat([p.grad.flatten() for n, p in tr.model_params
                                 if n.startswith(prefix)]).cpu()
                for name, prefix in everything.items()}
        runs[device] = ({k: v.detach().item() for k, v in metrics.items()}, flat,
                        out.get("indices"), out["code"].detach().cpu(), tr)
    (m_g, g_g, idx_g, code_g, _), (m_c, g_c, idx_c, code_c, tr_c) = runs["cuda"], runs["cpu"]
    terms = [k for k in LOSS_TERMS if k in m_c]
    rel = {k: abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in terms}
    cos = {k: torch.nn.functional.cosine_similarity(g_g[k], g_c[k], dim=0).item() for k in grads}
    check(all(v <= 5e-2 for v in rel.values()), f"{what}: loss rel errors {rel}")
    check(all(v >= 0.98 for v in cos.values()), f"{what}: gradient cosines {cos}")
    row = {"batch": len(batch["img"]), "tf32": False, "loss_rel_err": rel, "grad_cosine": cos,
           "card": {k: m_g[k] for k in terms}, "cpu": {k: m_c[k] for k in terms}}
    if reported:
        row["grad_cosine_reported"] = {
            k: torch.nn.functional.cosine_similarity(g_g[k], g_c[k], dim=0).item()
            for k in reported}
    if idx_c is None or not indices:
        pass
    elif not quantizer:
        row["index_agreement"] = (idx_g.cpu() == idx_c).float().mean().item()
        check(row["index_agreement"] >= 0.95,
              f"{what}: end-to-end index agreement {row['index_agreement']}")
    else:
        m = tr_c.model
        pq_cfg = model_pq_cfg(m)
        with torch.no_grad():
            _, idx_s, _, _ = pq_forward(code_g, dict(m.pq), m.pq_state.as_dict(), pq_cfg,
                                        training=True)
        same = (idx_g.cpu() == idx_c).reshape(-1, pq_cfg.num_pq)
        row["quantizer_on_card_code_agreement"] = (idx_s == idx_g.cpu()).float().mean().item()
        row["index_agreement"] = same.float().mean().item()
        check(row["quantizer_on_card_code_agreement"] >= 0.995,
              f"{what}: quantizer on the card's code, agreement "
              f"{row['quantizer_on_card_code_agreement']}")
        if e2e_bar:
            check(row["index_agreement"] >= 0.95,
                  f"{what}: end-to-end index agreement {row['index_agreement']}")
        else:
            tied, untied = minimum_ties(tr_c, code_c)
            row["cpu_tied_minimum_share"] = tied
            row["cpu_untied_share"] = untied.float().mean().item()
            row["untied_pairs"] = int(untied.sum())
            row["untied_index_agreement"] = (same[untied].float().mean().item()
                                             if row["untied_pairs"] else None)
            check(not row["untied_pairs"] or row["untied_index_agreement"] >= 0.95,
                  f"{what}: end-to-end index agreement on untied pairs "
                  f"{row['untied_index_agreement']}")
    for k in ("jsd", "entropy"):
        if k in m_c:
            row[f"{k}_rel_err"] = abs(m_g[k] - m_c[k]) / abs(m_c[k])
    return row


def phase_pqgo_exact(results: dict) -> None:
    """The preset with ``model.vq.assign_precision: exact`` (the JAX
    default) and ``model.vq.use_pallas: 1`` (the kernel's training route,
    ``AssignSTE``): 4 train steps at b = 16 (+16 positives) on 224^2 after
    2 warm-up ones, then ``validate`` over 4 batches of b = 8 at 320^2
    after 2 warm-up steps; 12 attention and 1 PQ launch per step, the PQ
    kernel's narrow exact body at n = 12 544 and 12 800; every loss
    finite; a profile of two steps of each, which names the body's device
    ms per launch and its share of the f32 bound."""
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.train.trainer import Trainer

    cfg = with_overrides(PQGO_COCOSTUFF27, {"model.vq.assign_precision": "exact",
                                            "model.vq.use_pallas": 1})
    tr = Trainer(cfg, device="cuda", seed=0)
    batches = list(synthetic_batches(13, 6, 16, res=224, num_classes=27))
    metrics, timing = timed_train(tr, batches, 2, SERVE_KERNELS, "pqgo_exact_train", results)
    emit({"phase": "pqgo_exact", "what": "train", "batch": 16, **timing,
          **{f"{k}_per_step": [m[k] for m in metrics]
             for k in ("loss", "stego-loss", "vq-loss", "linear-loss", "cluster-loss")}})
    cycle = iter(batches * 2)
    prof = device_profile(lambda: tr.train_step(next(cycle)), 2, pick=KERNEL_PICK)
    emit({"phase": "profile", "what": "pqgo_exact_train", "batch": 16, "steps": 2, **prof,
          **narrow_exact_in_path(prof, 16 * 28 * 28, "pqgo exact train")})

    vb = valid_batches(6, 8, seed=331)
    val, res, timing = timed_validate(tr, vb, 2, SERVE_KERNELS, "pqgo_exact_valid", results)
    check(tuple(res["pq_indices"].shape) == (8, 40, 40, 64), "pqgo exact valid: index shape")
    emit({"phase": "pqgo_exact", "what": "valid", "batch": 8, "res": 320, **timing, **val})
    cycle = iter(vb * 2)
    prof = device_profile(lambda: tr.valid_step(next(cycle)), 2, pick=KERNEL_PICK)
    emit({"phase": "profile", "what": "pqgo_exact_valid", "batch": 8, "res": 320, "steps": 2,
          **prof, **narrow_exact_in_path(prof, 8 * 40 * 40, "pqgo exact valid")})
    del tr
    torch.cuda.empty_cache()


def phase_train_reference() -> None:
    """One ``kernel`` train step at b = 2, dropout off, the same STEGO
    samples, on the card against the CPU (``reference_step``; gradients of
    the head and the codebook)."""
    from equss_tpu_torch.data.synthetic import synthetic_batches

    batch = stego_samples(next(synthetic_batches(7, 1, 2, res=224, num_classes=27)), 7)
    row = reference_step(lambda device: train_model("kernel", device=device, dropout=False)[1],
                         batch, {"head": "head.", "codebook": "pq.codebook"}, "train reference")
    emit({"phase": "train_reference_cpu", "config": "kernel", **row})


def valid_batches(n: int, batch: int, seed: int, num_classes: int = 27) -> list:
    """``n`` synthetic host batches of ``batch`` 320^2 images without
    positives; 10% of the labels set to -1 (ignored, as unlabelled pixels
    are)."""
    from equss_tpu_torch.data.synthetic import synthetic_batches

    rng = np.random.RandomState(seed)
    out = []
    for b in synthetic_batches(seed, n, batch, res=320, num_classes=num_classes,
                               with_pos=False):
        b["label"][rng.rand(*b["label"].shape) < 0.1] = -1
        out.append(b)
    return out


VALID_METRICS = ("Linear_mIoU", "Linear_Accuracy", "Cluster_mIoU", "Cluster_Accuracy")


def check_valid_metrics(val: dict, what: str) -> None:
    check(all(np.isfinite(val[k]) and 0.0 <= val[k] <= 100.0 for k in VALID_METRICS)
          and all(np.isfinite(val[k]) for k in ("val_linear_loss", "val_cluster_loss")),
          f"{what}: metrics {val}")


def phase_valid(results: dict) -> None:
    """``Trainer.validate`` of both train configurations (seeded weights)
    over 4 batches of b = 8 at 320^2, counted from 0: exact launches per
    valid step, every metric finite and in [0, 100]; then each valid step
    timed alone on the same batches (host clock to a synchronised end,
    after 2 warm-up steps) and a profile of two valid steps."""
    from equss_tpu_torch import launch_counts, reset_launch_counts

    warm, steps = 2, 4
    batches = valid_batches(warm + steps, 8, seed=320)
    for kind, per_step in (("stock", SERVE_KERNELS), ("kernel", FUSED_LN_KERNELS)):
        _, tr = train_model(kind)
        for b in batches[:warm]:
            tr.valid_step(b)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        val = tr.validate(batches[warm:])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        results["launches"][f"valid_{kind}"] = counts
        check(counts == expected(per_step, steps), f"valid {kind}: launches {counts}")
        check_valid_metrics(val, f"valid {kind}")
        times = []
        for b in batches[warm:]:
            t0 = time.perf_counter()
            res = tr.valid_step(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        check(tuple(res["linear_preds"].shape) == (8, 320, 320)
              and tuple(res["pq_indices"].shape) == (8, 40, 40, 64),
              f"valid {kind}: shapes")
        t = sorted(times)
        emit({"phase": "valid", "config": kind, "batch": 8, "res": 320, "batches": steps,
              "validate_seconds": seconds, "ms_per_valid_step_median": 1e3 * t[steps // 2],
              "ms_per_valid_step_min": 1e3 * t[0],
              "launches_per_valid_step": {k: v / steps for k, v in counts.items()}, **val})
        cycle = iter(batches * 2)
        emit({"phase": "profile", "what": f"valid_{kind}", "batch": 8, "res": 320, "steps": 2,
              **device_profile(lambda: tr.valid_step(next(cycle)), 2,
                               pick=KERNEL_PICK + ("indexFunc", "Memcpy"))})
        del tr
        torch.cuda.empty_cache()


def phase_valid_reference() -> None:
    """One valid step of the preset at b = 2, 320^2, on the card and on
    the CPU (plain kernel versions, the PQ kernel's) from the same seeded
    weights.  With random weights a prediction is a 27-way argmax over
    64 subspaces' codewords, and one flipped codeword of 64 flips it
    often, so the predictions are held where the codewords agree:
    * end to end: PQ indices >= 95% equal (the end-to-end class of the
      serving reference);
    * z_q on every feature pixel whose 64 indices all agree: card and
      CPU within 4 f32 ulps of max(1, |z_q|) (z_q is the straight-through
      value z_norm + (c - z_norm) of the bf16-rounded codeword c, with
      |z_norm| <= 1 under l2: two roundings a side, within 1.5 ulps);
    * predictions on every label pixel whose bilinear taps (the probes'
      resize) all fall on such feature pixels, at least 500 of them:
      >= 99.9% equal (f32 probes on both sides; only sums in another
      order);
    * the CPU's probes on the card's own z_q: >= 99.9% of predictions
      equal to the card's.
    Agreement on all pixels and the three sets of confusion matrices
    are printed beside."""
    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.eval.metrics import confusion_update
    from equss_tpu_torch.ops.resize import resize2d

    batch = valid_batches(1, 2, seed=321)[0]
    _, tr_g = train_model("stock")
    _, tr_c = train_model("stock", device="cpu")
    tr_c.model.cfg = dataclasses.replace(
        tr_c.model.cfg, pq=dataclasses.replace(tr_c.model.cfg.pq, use_pallas=True))
    g = {k: v.cpu() for k, v in tr_g.valid_step(batch).items()}
    c = {k: v.cpu() for k, v in tr_c.valid_step(batch).items()}
    idx_g, idx_c = g["pq_indices"], c["pq_indices"]
    index_agree = (idx_g == idx_c).float().mean().item()
    same_px = (idx_g == idx_c).all(-1)                          # (b, 40, 40)
    e2e = {k: (g[k] == c[k]).float().mean().item() for k in ("linear_preds", "cluster_preds")}
    check(index_agree >= 0.95, f"valid reference: end-to-end index agreement {index_agree}")

    label = torch.from_numpy(batch["label"]).long()
    img = normalize_images(torch.from_numpy(batch["img"]))
    with torch.no_grad():
        z_q = tr_g.model(img.cuda())["z_q"].cpu()
        z_q_c = tr_c.model(img)["z_q"]
        ev = tr_c.evaluator(z_q, label)
    zq_err = (z_q - z_q_c).abs()[same_px].max().item()
    zq_tol = 4 * 2.0 ** (math.floor(math.log2(max(1.0, z_q_c.abs().max().item()))) - 23)
    check(zq_err <= zq_tol, f"valid reference: z_q where all indices agree, max err "
                            f"{zq_err} > {zq_tol}")
    # a label pixel is clean where the bilinear resize of the probes'
    # logits (non-negative weights) takes no feature pixel that disagrees
    taps_differ = resize2d((~same_px).float()[..., None], tuple(label.shape[-2:]), "bilinear")
    clean = taps_differ[..., 0] == 0
    n_clean = int(clean.sum())
    on_clean = {k: (g[k] == c[k])[clean].float().mean().item() if n_clean else 0.0
                for k in ("linear_preds", "cluster_preds")}
    check(n_clean >= 500 and all(v >= 0.999 for v in on_clean.values()),
          f"valid reference: predictions on {n_clean} clean pixels, agreement {on_clean}")
    stage = {k: (g[k] == ev[k]).float().mean().item() for k in ("linear_preds", "cluster_preds")}
    check(all(v >= 0.999 for v in stage.values()),
          f"valid reference: probes on the card's z_q, agreement {stage}")
    emit({"phase": "valid_reference_cpu", "config": "stock", "batch": 2, "res": 320,
          "end_to_end_index_agreement": index_agree,
          "end_to_end_pixels_all_indices_equal": same_px.float().mean().item(),
          "z_q_max_err_where_indices_equal": zq_err, "z_q_tolerance": zq_tol,
          "clean_label_pixels": n_clean,
          "prediction_agreement_on_clean_pixels": on_clean,
          "end_to_end_prediction_agreement": e2e,
          "probes_on_card_z_q_prediction_agreement": stage,
          "linear_loss": {"card": g["linear_loss"].item(), "cpu": c["linear_loss"].item(),
                          "cpu_on_card_z_q": ev["linear_loss"].item()},
          "cluster_loss": {"card": g["cluster_loss"].item(), "cpu": c["cluster_loss"].item(),
                           "cpu_on_card_z_q": ev["cluster_loss"].item()},
          "linear_conf": {"card": g["linear_conf"].tolist(), "cpu": c["linear_conf"].tolist(),
                          "cpu_on_card_z_q": confusion_update(
                              ev["linear_preds"], label, 27).tolist()},
          "cluster_conf": {"card": g["cluster_conf"].tolist(),
                           "cpu": c["cluster_conf"].tolist(),
                           "cpu_on_card_z_q": confusion_update(
                               ev["cluster_preds"], label, 27).tolist()}})


class Recorder:
    """A logger for ``Trainer.fit`` that keeps every ``log`` call."""

    def __init__(self):
        self.records = []

    def log(self, metrics, step):
        self.records.append((step, dict(metrics)))

    def banner(self, msg):
        pass


def phase_fit(results: dict) -> None:
    """``Trainer.fit`` of the preset: one epoch of 4 train steps at b = 16
    (224^2), a log every step, validation every 2 steps and at the
    epoch's end on 2 batches of b = 8 at 320^2; launches counted from 0
    over the whole run."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.data.synthetic import synthetic_batches

    train = list(synthetic_batches(16, 4, 16, res=224, num_classes=27))
    val = valid_batches(2, 8, seed=322)
    _, tr = train_model("stock", max_epochs=1, iter_per_epoch=4, print_interval_iters=1,
                        valid_interval_iters=2)
    logger = Recorder()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = tr.fit(lambda epoch: train, lambda: val, logger=logger)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    results["launches"]["fit"] = counts
    train_launches = expected(STOCK_TRAIN_KERNELS, 4)
    valid_launches = expected(SERVE_KERNELS, 3 * len(val))
    want = {k: train_launches[k] + valid_launches[k] for k in counts}
    check(counts == want, f"fit: launches {counts}, expected {want}")
    steps = [s for s, _ in logger.records]
    best = out["best"]
    check(steps == [1, 2, 2, 3, 4, 4, 4], f"fit: logged steps {steps}")
    check((best.get("epoch"), best.get("iter")) in ((0, 2), (0, 4)), f"fit: best {best}")
    check_valid_metrics(best, "fit best")
    check(all(np.isfinite(v) for _, m in logger.records for v in m.values())
          and not any(m.get("skipped") for _, m in logger.records), "fit: non-finite log")
    emit({"phase": "fit", "config": "stock", "train_steps": 4, "train_batch": 16,
          "valid_batches": len(val), "valid_batch": 8, "wall_seconds": seconds,
          "logged_steps": steps, "best": best,
          "iter_time": [m["iter_time"] for _, m in logger.records if "iter_time" in m]})


def crf_inputs(H: int, W: int, C: int, seed: int):
    """A normalised (H, W, 3) image of flat 12 x 12 colour cells with a
    little noise, and (H, W, C) log-probabilities smooth over 4 x 4 cells
    with noise, on the host: the image and unaries a probe gives the CRF."""
    from equss_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    rng = np.random.RandomState(seed)
    cells = rng.rand(H // 12 + 1, W // 12 + 1, 3)
    img01 = np.repeat(np.repeat(cells, 12, 0), 12, 1)[:H, :W] + 0.03 * rng.randn(H, W, 3)
    img = (np.clip(img01, 0, 1) - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    lg = np.repeat(np.repeat(rng.randn(H // 4 + 1, W // 4 + 1, C), 4, 0), 4, 1)[:H, :W]
    lg = lg + 0.5 * rng.randn(H, W, C)
    log_p = torch.log_softmax(torch.from_numpy(lg.astype(np.float32)), -1)
    return torch.from_numpy(img.astype(np.float32)), log_p


def phase_crf() -> None:
    """The dense CRF on the card (no TPU kernel: plain ops in both packages).
    * 60 x 76 (N = 4 560, so the 512-row blocks leave a remainder), C = 27,
      10 iterations, card against CPU: argmax >= 99.9% equal and >= 99.9%
      of the probabilities within 1e-3.  Not all of them: the distance of
      two bright pixels rounds at an ulp of 2 |f|^2 (~0.004), so another
      order of the f32 sums (the card's GEMM and reductions) moves a few
      kernel weights by ~0.2% and, through the mean field, a few
      probabilities by more than 1e-3.  The largest difference is printed.
    * 320^2, one image: the bf16-message refinement against the f32-message
      one, argmax agreement >= 99% (printed).
    * ms of one bilateral pass at 320^2, C = 27 (CUDA events), with its
      bounds: N^2 exponentials at 16 per clock per SM, the message product
      on the tensor cores (bf16; the f32 product's CUDA-core bound is
      printed beside it), the distances on the CUDA cores; the pass's
      bound is the largest of these; and the passes per image of the final CRF
      evaluation (2 probes x (1 + 10))."""
    from equss_tpu_torch.data.transforms import unnormalize_images
    from equss_tpu_torch.ops import crf

    cfg = crf.CRFConfig()
    img, log_p = crf_inputs(60, 76, 27, seed=60)
    t0 = time.perf_counter()
    card = crf.dense_crf(img.cuda(), log_p.cuda(), cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = crf.dense_crf(img, log_p, cfg)
    diff = (card.cpu() - cpu).abs()
    small = dict(max_abs_diff=diff.max().item(),
                 frac_within_1e3=(diff <= 1e-3).float().mean().item(),
                 argmax_agreement=(card.cpu().argmax(-1) == cpu.argmax(-1)).float().mean().item())
    check(small["argmax_agreement"] >= 0.999 and small["frac_within_1e3"] >= 0.999
          and bool(torch.isfinite(card).all()), f"crf card vs cpu: {small}")

    img, log_p = (t.cuda() for t in crf_inputs(320, 320, 27, seed=320))
    t0 = time.perf_counter()
    q16 = crf.dense_crf(img, log_p, cfg)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    q32 = crf.dense_crf(img, log_p, cfg, message_dtype=torch.float32)
    agree = (q16.argmax(-1) == q32.argmax(-1)).float().mean().item()
    check(agree >= 0.99 and bool(torch.isfinite(q16).all()),
          f"crf 320^2 bf16 vs f32 messages: argmax agreement {agree}")

    n, C = img.shape[0] * img.shape[1], log_p.shape[-1]
    rgb = unnormalize_images(img).clamp(0, 1) * 255
    feats = crf._bilateral_features(rgb, cfg)
    vals = torch.softmax(log_p.reshape(n, C), -1)
    ms = {f"{name}_block{block}": cuda_ms(
              lambda: crf._blocked_kernel_apply(feats, vals, block, dtype), iters=3, warmup=1)
          for name, dtype, block in (("bf16", torch.bfloat16, 512), ("f32", torch.float32, 512),
                                     ("bf16", torch.bfloat16, 2048))}
    exp_ms = exp_bound_ms(float(n) * n)
    product_bf16_ms = 1e3 * 2.0 * n * n * C / PEAK_BF16_FLOPS
    product_f32_ms = 1e3 * 2.0 * n * n * C / PEAK_F32_FLOPS
    dist_ms = 1e3 * 2.0 * n * n * 5 / PEAK_F32_FLOPS
    bytes_ms = 1e3 * (n * 5 * 4 + n * C * 2 + n * C * 4) / PEAK_BYTES
    bound = max(exp_ms, dist_ms, bytes_ms, product_bf16_ms)
    emit({"phase": "crf", "card_vs_cpu_60x76": small, "card_60x76_seconds": card_s,
          "tolerance": "argmax >= 99.9%, >= 99.9% of probabilities within 1e-3",
          "bf16_vs_f32_messages_320_argmax_agreement": agree,
          "dense_crf_320_seconds": full_s,
          "pass_ms_320_c27": ms, "bound_ms": bound, "exp_bound_ms": exp_ms,
          "product_bf16_bound_ms": product_bf16_ms, "product_f32_bound_ms": product_f32_ms,
          "distance_f32_bound_ms": dist_ms, "bytes_bound_ms": bytes_ms,
          "passes_per_image_final_crf": 2 * (1 + cfg.max_iter)})


def read_metrics(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def with_overrides(cfg: dict, overrides: dict) -> dict:
    """A copy of ``cfg`` with each dotted key of ``overrides`` set to its
    value (what ``a.b=c`` overrides do, without a YAML reader)."""
    cfg = copy.deepcopy(cfg)
    for dotted, value in overrides.items():
        *path, last = dotted.split(".")
        node = cfg
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value
    return cfg


def phase_cli(results: dict) -> None:
    """``cli.run`` on the preset (a dict config, its ``${...}`` resolved by
    the port's loader), synthetic data, 4 train steps at b = 16 and one
    val batch of b = 8 at 320^2, a log every step, validation every 2
    steps: train, checkpoint on each new best, reload the best, final and
    final CRF evaluation.  Each valid CRF step's launches are counted (12
    attention and 1 PQ) and timed; every run's launches are counted from
    0.  Then an eval-only resume of the run's checkpoints
    (``final_Cluster_mIoU`` and ``final_crf_Cluster_mIoU`` within 1e-6)
    and a train resume from its step-2 checkpoint without the final CRF
    (losses of steps 3 and 4 within rtol 1e-3; the card's backward adds
    with atomics, so not bit for bit)."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.cli import run
    from equss_tpu_torch.core.config import resolve_config
    from equss_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="equss_cli_")
    crf_steps = []
    plain_step = Trainer.valid_crf_step

    def counted_step(self, batch):
        torch.cuda.synchronize()
        before, t0 = launch_counts(), time.perf_counter()
        out = plain_step(self, batch)
        torch.cuda.synchronize()
        after = launch_counts()
        crf_steps.append(({k: after[k] - before[k] for k in after},
                          time.perf_counter() - t0))
        return out

    def cli_run(name, overrides=None):
        cfg = resolve_config(with_overrides(PQGO_COCOSTUFF27, {
            "dataset.synthetic": True, "dataset.synthetic_batches": 4, "train.max_epochs": 1,
            "train.valid_interval_iters": 2, "train.print_interval_iters": 1,
            "save_dir": f"{root}/{name}", **(overrides or {})}))
        cfg["debug"] = True
        crf_steps.clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        results["launches"][f"cli_{name}"] = launch_counts()
        (run_dir,) = [os.path.join(root, name, d) for d in os.listdir(os.path.join(root, name))]
        return out, run_dir, seconds, list(crf_steps)

    Trainer.valid_crf_step = counted_step
    try:
        full, run_dir, seconds, steps = cli_run("train")
        records = read_metrics(run_dir)
        saved = sorted(int(d) for d in os.listdir(os.path.join(run_dir, "ckpt")))
        final = next(r for r in records if "final_Cluster_mIoU" in r)
        final_crf = next((r for r in records if "final_crf_Cluster_mIoU" in r), {})
        logged = [r["step"] for r in records if "final_Cluster_mIoU" not in r
                  and "final_crf_Cluster_mIoU" not in r]
        check(logged == [1, 2, 2, 3, 4, 4, 4], f"cli: logged steps {logged}")
        check(bool(saved) and saved[0] == 2 and final["step"] == saved[-1],
              f"cli: checkpoints {saved}, final eval at step {final['step']}")
        crf_keys = ("Cluster_mIoU", "Cluster_Accuracy", "Linear_mIoU", "Linear_Accuracy")
        check(all(0.0 <= final_crf.get(f"final_crf_{k}", -1.0) <= 100.0 for k in crf_keys),
              f"cli: final CRF metrics {final_crf}")
        check(len(steps) == 1 and steps[0][0] == expected(SERVE_KERNELS, 1),
              f"cli: launches per valid CRF step {[c for c, _ in steps]}")
        train_launches, valid_launches = (expected(STOCK_TRAIN_KERNELS, 4),
                                          expected(SERVE_KERNELS, 5))
        want = {k: train_launches[k] + valid_launches[k] for k in train_launches}
        check(results["launches"]["cli_train"] == want,
              f"cli: launches {results['launches']['cli_train']}, expected {want}")
        losses = {r["step"]: r["loss"] for r in records if "loss" in r}
        emit({"phase": "cli", "run": "train", "wall_seconds": seconds, "logged_steps": logged,
              "checkpoint_steps": saved, "best": full["best"],
              "final": {k: v for k, v in final.items() if k != "step"}, "final_step": final["step"],
              "final_crf": {k: v for k, v in final_crf.items() if k != "step"},
              "final_crf_seconds": sum(t for _, t in steps),
              "valid_crf_step_seconds": [t for _, t in steps],
              "launches_per_valid_crf_step": [c for c, _ in steps],
              "launches": results["launches"]["cli_train"], "losses": losses})

        ckpt_dir = os.path.join(run_dir, "ckpt")
        evald, _, seconds, steps = cli_run("eval", {"resume.checkpoint": ckpt_dir,
                                                    "resume.mode": "eval"})
        diff = abs(evald["best"]["Cluster_mIoU"] - final["final_Cluster_mIoU"])
        crf_diff = abs(evald["best"].get("crf_Cluster_mIoU", -1.0)
                       - final_crf.get("final_crf_Cluster_mIoU", -2.0))
        check(diff <= 1e-6 and crf_diff <= 1e-6,
              f"cli eval-only resume: final_Cluster_mIoU differs by {diff}, "
              f"final_crf_Cluster_mIoU by {crf_diff}")
        emit({"phase": "cli", "run": "resume_eval", "wall_seconds": seconds,
              "final_Cluster_mIoU": evald["best"]["Cluster_mIoU"], "difference": diff,
              "final_crf_Cluster_mIoU": evald["best"].get("crf_Cluster_mIoU"),
              "crf_difference": crf_diff,
              "launches_per_valid_crf_step": [c for c, _ in steps]})

        step2 = os.path.join(root, "from_step2")
        shutil.copytree(os.path.join(ckpt_dir, "2"), os.path.join(step2, "2"))
        resumed, run_dir2, seconds, steps = cli_run("resume", {
            "resume.checkpoint": step2, "resume.mode": "train", "eval.final_crf": False})
        check(not steps, f"cli train resume: {len(steps)} valid CRF steps with final_crf off")
        losses2 = {r["step"]: r["loss"] for r in read_metrics(run_dir2) if "loss" in r}
        rel = {s: abs(losses2[s] - losses[s]) / abs(losses[s]) for s in losses2}
        check(sorted(losses2) == [3, 4] and all(v <= 1e-3 for v in rel.values()),
              f"cli train resume: losses {losses2} vs {losses}")
        param_diff = max((resumed["state"][k].float() - v.float()).abs().max().item()
                         for k, v in full["state"].items() if not k.startswith("backbone."))
        emit({"phase": "cli", "run": "resume_train", "wall_seconds": seconds,
              "losses": losses2, "loss_rel_diff": rel,
              "max_param_abs_diff_vs_uninterrupted": param_diff})
    finally:
        Trainer.valid_crf_step = plain_step
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------ the last single-device slice

def png_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def colored(arr: np.ndarray, cmap: np.ndarray) -> np.ndarray:
    """``utils/visualize.py``'s colouring of an id map."""
    rgb = cmap[np.clip(arr, 0, len(cmap) - 1)].astype(np.uint8)
    rgb[arr < 0] = 0
    return rgb


def rest_visualize(results: dict) -> None:
    """``Trainer.validate(visualize_to=...)`` of the preset (stock) over 2
    batches of b = 8 at 320^2, counted from 0: 12 attention and 1 PQ
    launches per valid step, as without PNGs; the metrics equal to a
    validate without PNGs; 16 PNGs in each of linear, cluster, label and
    the 64 ``pq_<m>``; every cluster PNG the colour of the predictions
    remapped by the Hungarian matching, every ``pq_<m>`` PNG the colour
    of the codeword ids upsampled by 8; the host seconds the PNGs add per
    batch."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.core.config import resolve_config
    from equss_tpu_torch.data.catalog import create_pascal_label_colormap, create_pq_colormap
    from equss_tpu_torch.eval.metrics import UnSegMetrics
    from equss_tpu_torch.train.trainer import Trainer

    steps = 2
    batches = valid_batches(steps + 1, 8, seed=321)
    # resolved, so that dataset.val.dataset_name names the colormap
    tr = Trainer(resolve_config(train_config("stock")), device="cuda")
    tr.valid_step(batches[0])
    torch.cuda.synchronize()
    out_dir = tempfile.mkdtemp(prefix="equss_viz_")
    try:
        t0 = time.perf_counter()
        plain = tr.validate(batches[1:])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        reset_launch_counts()
        t0 = time.perf_counter()
        val = tr.validate(batches[1:], visualize_to=out_dir)
        torch.cuda.synchronize()
        viz_s = time.perf_counter() - t0
        counts = launch_counts()
        results["launches"]["rest_visualize"] = counts
        check(counts == expected(SERVE_KERNELS, steps), f"rest visualize: launches {counts}")
        check(val == plain, f"rest visualize: metrics {val} vs {plain}")
        dirs = sorted(os.listdir(out_dir))
        want_dirs = sorted(["linear", "cluster", "label", *(f"pq_{m}" for m in range(64))])
        pngs = {d: len(os.listdir(os.path.join(out_dir, d))) for d in dirs}
        check(dirs == want_dirs and set(pngs.values()) == {8 * steps},
              f"rest visualize: PNG directories {pngs}")
        res = [tr.valid_step(b) for b in batches[1:]]
        cluster_m = UnSegMetrics(27, 0, compute_hungarian=True)
        cluster_m.update_confusion(sum(r["cluster_conf"] for r in res).cpu())
        cluster_m.compute()
        mapped = cluster_m.map_clusters(torch.cat([r["cluster_preds"] for r in res]).cpu().numpy())
        idx = torch.cat([r["pq_indices"] for r in res]).cpu().numpy()
        cmap, pq_cmap = create_pascal_label_colormap(), create_pq_colormap()
        cluster_equal = [np.array_equal(png_rgb(f"{out_dir}/cluster/{i}.png"),
                                        colored(mapped[i], cmap)) for i in range(8 * steps)]
        pq_equal = [np.array_equal(png_rgb(f"{out_dir}/pq_{m}/{i}.png"), colored(
            np.repeat(np.repeat(idx[i, :, :, m] % len(pq_cmap), 8, 0), 8, 1), pq_cmap))
            for i in (0, 8 * steps - 1) for m in (0, 63)]
        check(all(cluster_equal) and all(pq_equal),
              f"rest visualize: PNGs read back {cluster_equal} {pq_equal}")
        emit({"phase": "rest", "what": "visualize", "batch": 8, "res": 320, "batches": steps,
              "validate_seconds": viz_s, "validate_seconds_without_pngs": plain_s,
              "png_host_seconds_per_batch": (viz_s - plain_s) / steps,
              "pngs": sum(pngs.values()), "png_bytes": sum(
                  os.path.getsize(os.path.join(out_dir, d, f)) for d in dirs
                  for f in os.listdir(os.path.join(out_dir, d))),
              "launches_per_valid_step": {k: v / steps for k, v in counts.items()},
              "cluster_pngs_equal": sum(cluster_equal), "pq_pngs_checked": len(pq_equal)})
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()


def rest_cli_profile(results: dict) -> None:
    """``cli.run`` on the preset with synthetic data, ``train.profile_dir``
    and ``is_visualize``: 2 train steps at b = 16, a validation at step 2
    and at the epoch's end and the final evaluation (one batch of b = 8 at
    320^2 each), no final CRF.  Launches counted from 0 (12 attention per
    step, 12 + 1 per valid step); the Chrome trace's size, its ``equss::``
    op names (both kernels' ops must be there) and its kernel events; the
    final evaluation's PNGs under ``<visualize_path>/<step>/``."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.cli import run
    from equss_tpu_torch.core.config import resolve_config

    root = tempfile.mkdtemp(prefix="equss_prof_")
    try:
        cfg = resolve_config(with_overrides(PQGO_COCOSTUFF27, {
            "dataset.synthetic": True, "dataset.synthetic_batches": 2, "train.max_epochs": 1,
            "train.valid_interval_iters": 2, "train.print_interval_iters": 1,
            "save_dir": f"{root}/runs", "train.profile_dir": f"{root}/prof",
            "is_visualize": True, "visualize_path": f"{root}/viz", "eval.final_crf": False,
            "eval.visualize_pq_subspaces": [0, 63]}))
        cfg["debug"] = True
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        results["launches"]["rest_cli_profile"] = counts
        train_l, valid_l = expected(STOCK_TRAIN_KERNELS, 2), expected(SERVE_KERNELS, 3)
        want = {k: train_l[k] + valid_l[k] for k in train_l}
        check(counts == want, f"rest cli profile: launches {counts}, expected {want}")
        trace = f"{root}/prof/trace_rank0.json"
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
        ops, kernel_events = {}, 0
        if size:
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            for e in events:
                name = str(e.get("name", ""))
                if name.startswith("equss::"):
                    ops[name] = ops.get(name, 0) + 1
                kernel_events += e.get("cat") == "kernel"
        check({"equss::attention_qkv", "equss::pq_assign"} <= set(ops) and kernel_events > 0,
              f"rest cli profile: trace {size} bytes, ops {ops}, kernels {kernel_events}")
        viz = f"{root}/viz/{out['best']['iter']}"
        pngs = ({d: len(os.listdir(os.path.join(viz, d))) for d in sorted(os.listdir(viz))}
                if os.path.isdir(viz) else {})
        check(pngs == {d: 8 for d in ("cluster", "label", "linear", "pq_0", "pq_63")},
              f"rest cli profile: PNGs {pngs}")
        emit({"phase": "rest", "what": "cli_profile", "wall_seconds": seconds,
              "trace_bytes": size, "equss_ops": ops, "kernel_events": kernel_events,
              "pngs": pngs, "launches": counts})
    finally:
        shutil.rmtree(root, ignore_errors=True)


def rest_cache(results: dict) -> None:
    """The frozen-feature cache of the preset: ``precompute_features`` of
    one batch of 32 synthetic 224^2 images (12 attention launches,
    counted from 0; images per second with and without the compressed
    write), then the preset's train step at b = 16 from the cached
    features (kNN positives from a seeded table; no backbone, so no
    attention launch) against the image train step, in turns, 6 steps
    each: each step's median."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.data import feature_cache
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.data.transforms import normalize_images

    class Images:
        def batches(self, batch_size, shuffle=False, drop_last=False):
            return synthetic_batches(11, 1, batch_size, res=224, num_classes=27, with_pos=False)

    _, tr = train_model("stock")
    root = tempfile.mkdtemp(prefix="equss_cache_")
    write = np.savez_compressed
    written = []

    def timed_write(*args, **kwargs):
        t0 = time.perf_counter()
        write(*args, **kwargs)
        written.append(time.perf_counter() - t0)

    try:
        warm = next(iter(Images().batches(32)))["img"]
        tr.model.features(normalize_images(torch.as_tensor(warm).to("cuda")))
        feature_cache.np.savez_compressed = timed_write
        reset_launch_counts()
        t0 = time.perf_counter()
        path = feature_cache.precompute_features(tr.model, Images(), f"{root}/feats.npz",
                                                 batch_size=32)
        seconds = time.perf_counter() - t0
        feature_cache.np.savez_compressed = write
        counts = launch_counts()
        results["launches"]["rest_cache"] = counts
        check(counts == expected({"attention_qkv": 12}, 1), f"rest cache: launches {counts}")
        blob = np.load(path)
        feats = blob["feats"]
        check(feats.shape == (32, 28, 28, 384) and feats.dtype == np.float32
              and bool(np.isfinite(feats).all()) and blob["labels"].shape == (32, 224, 224),
              f"rest cache: {feats.shape} {feats.dtype}")
        nns = np.random.RandomState(0).randint(0, 32, (32, 8))
        cached = list(feature_cache.cached_feature_batches(path, nns, 16, seed=0))
        images = list(synthetic_batches(12, 2, 16, res=224, num_classes=27))
        times = {"cached": [], "image": []}
        for b in cached[:2] + images[:2]:
            tr.train_step(b)
        torch.cuda.synchronize()
        reset_launch_counts()
        for rnd in range(3):
            for kind in (("cached", "image") if rnd % 2 == 0 else ("image", "cached")):
                for b in (cached if kind == "cached" else images):
                    t0 = time.perf_counter()
                    m = tr.train_step(b)
                    torch.cuda.synchronize()
                    times[kind].append(time.perf_counter() - t0)
                    check(m["skipped"] == 0.0 and np.isfinite(m["loss"]),
                          f"rest cache: {kind} step {m}")
        steps_counts = launch_counts()
        check(steps_counts == expected(STOCK_TRAIN_KERNELS, 6),
              f"rest cache: 6 image and 6 cached steps launched {steps_counts}")
        med = {k: 1e3 * sorted(v)[len(v) // 2] for k, v in times.items()}
        emit({"phase": "rest", "what": "feature_cache", "images": 32, "batch": 32, "res": 224,
              "seconds": seconds, "images_per_second": 32 / seconds,
              "write_seconds": sum(written),
              "images_per_second_without_write": 32 / (seconds - sum(written)),
              "file_bytes": os.path.getsize(path),
              "launches_per_batch": counts,
              "train_batch": 16, "cached_step_ms_median": med["cached"],
              "image_step_ms_median": med["image"],
              "image_over_cached": med["image"] / med["cached"], "steps_each": 6})
    finally:
        feature_cache.np.savez_compressed = write
        shutil.rmtree(root, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()


def rest_backbone(results: dict) -> None:
    """The preset's ViT-S/8 (bf16, fused attention) at 224^2: at b = 8 the
    forward with ``want_attn`` and ``n_last=4`` (the plain attention
    path: no attention launch; the maps (8, 6, 785, 785), rows summing to
    1) against the fused forward (12 launches), ``dense`` within the
    serving class (mean relative error <= 2e-2, max abs <= 0.25), device
    ms of each in turns; at b = 128 the forward with ``ln_stats: bf16``
    against f32 statistics (the same weights, 12 launches each): device
    ms in turns and the relative error of the features."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig

    models = {}
    for stats in ("f32", "bf16"):
        cfg = with_overrides(PQGO_COCOSTUFF27, {"model.pretrained.ln_stats": stats})
        models[stats] = EQUSS(EQUSSConfig.from_config(cfg), device="cuda", seed=0).eval()
    models["bf16"].load_state_dict(models["f32"].state_dict())
    vit = models["f32"].backbone
    img8 = normalize_images(requests(8, 1, seed=21)[0].to("cuda"))
    img128 = normalize_images(requests(128, 1, seed=22)[0].to("cuda"))
    with torch.no_grad():
        reset_launch_counts()
        maps = vit(img8, want_attn=True, n_last=4)
        torch.cuda.synchronize()
        attn_launches = launch_counts()["attention_qkv"]
        reset_launch_counts()
        fused = vit(img8)
        dense = {s: m.backbone(img128)["dense"].float() for s, m in models.items()}
        torch.cuda.synchronize()
        counts = launch_counts()
        results["launches"]["rest_backbone"] = counts
        check(attn_launches == 0 and counts == expected({"attention_qkv": 36}, 1),
              f"rest backbone: {attn_launches} launches with maps, {counts} without")
        a, f_ = maps["dense"].float(), fused["dense"].float()
        rel = ((a - f_).abs().mean() / f_.abs().mean()).item()
        mx = (a - f_).abs().max().item()
        rows = max((m.float().sum(-1) - 1).abs().max().item() for m in maps["attn"])
        check(len(maps["attn"]) == len(maps["intermediates"]) == 4
              and tuple(maps["attn"][0].shape) == (8, 6, 785, 785)
              and maps["intermediates"][-1] is maps["tokens"] and rows <= 2e-2
              and rel <= 2e-2 and mx <= 0.25,
              f"rest backbone: want_attn dense rel {rel} max {mx}, rows {rows}")
        stats_rel = (torch.linalg.vector_norm(dense["bf16"] - dense["f32"])
                     / torch.linalg.vector_norm(dense["f32"])).item()
        stats_mean = ((dense["bf16"] - dense["f32"]).abs().mean()
                      / dense["f32"].abs().mean()).item()
        check(np.isfinite(stats_rel) and stats_rel <= 0.1,
              f"rest backbone: bf16 LayerNorm statistics rel err {stats_rel}")
        del maps, fused, dense
        ms8 = in_turns({"want_attn": lambda: vit(img8, want_attn=True, n_last=4),
                        "fused": lambda: vit(img8)}, iters=5, rounds=2)
        ms128 = in_turns({"ln_f32": lambda: models["f32"].backbone(img128),
                          "ln_bf16": lambda: models["bf16"].backbone(img128)},
                         iters=3, rounds=2)
    emit({"phase": "rest", "what": "backbone", "res": 224,
          "want_attn_b8_ms": ms8["want_attn"], "fused_b8_ms": ms8["fused"],
          "want_attn_dense_mean_rel_err": rel, "want_attn_dense_max_abs_err": mx,
          "attn_row_sum_max_err": rows, "ln_f32_b128_ms": ms128["ln_f32"],
          "ln_bf16_b128_ms": ms128["ln_bf16"],
          "ln_f32_over_bf16": ms128["ln_f32"] / ms128["ln_bf16"],
          "ln_bf16_features_rel_err": stats_rel, "ln_bf16_features_mean_rel_err": stats_mean})
    del models, vit
    torch.cuda.empty_cache()


REST_OPTIONS = (
    ("pqgo_restart_dropout", "pqgo", {"model.vq.use_restart": True, "model.vq.pq_dropout": 0.1}),
    ("pqgo_weighted_sum", "pqgo", {"model.vq.use_weighted_sum": True,
                                   "model.vq.normalize": "none"}),
    ("ema_restart_dropout", "vq_cocostuff27", {"model.vq.use_restart": True,
                                               "model.vq.pq_dropout": 0.1}),
)


def rest_quantizer_options(results: dict) -> None:
    """The quantizer options on the preset (param codebook) and on
    ``vq_cocostuff27`` (EMA), 1 warm-up and 2 steps at b = 16: the plain
    PQ route (12 attention launches and no PQ launch per step), finite
    and taken steps; restart: the param codebook's restart in the
    forward's aux, an EMA step with dead codewords resets the counts;
    weighted sum: z_q is no codeword; step medians beside each other."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.train.trainer import Trainer

    batches = list(synthetic_batches(13, 3, 16, res=224, num_classes=27))
    for name, base, changes in REST_OPTIONS:
        cfg = with_overrides(PQGO_COCOSTUFF27 if base == "pqgo" else preset(base), changes)
        tr = Trainer(cfg, device="cuda")
        _, out = tr.forward_backward(batches[0])
        extra = {}
        if name == "pqgo_restart_dropout":
            rc = out["aux"].get("restarted-codebook")
            check(rc is not None and tuple(rc.shape) == (64, 256, 16)
                  and bool(torch.isfinite(rc).all()), f"rest {name}: restarted codebook")
            if rc is not None:
                extra["restarted_codewords"] = int((rc != tr.model.pq.codebook).any(-1).sum())
        elif name == "pqgo_weighted_sum":
            zq = out["z_q"].reshape(-1, 64, 16)
            cb = tr.model.pq.codebook.detach()
            nearest = cb[torch.arange(64, device=cb.device), out["indices"].reshape(-1, 64).long()]
            extra["z_q_max_distance_to_its_codeword"] = (zq - nearest).abs().max().item()
            check(extra["z_q_max_distance_to_its_codeword"] > 0, f"rest {name}: z_q a codeword")
        del out
        tr.train_step(batches[0])
        torch.cuda.synchronize()
        reset_launch_counts()
        times, metrics = [], []
        for b in batches[1:]:
            t0 = time.perf_counter()
            metrics.append(tr.train_step(b))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = launch_counts()
        results["launches"][f"rest_{name}"] = counts
        check(counts == expected(STOCK_TRAIN_KERNELS, 2), f"rest {name}: launches {counts}")
        check(all(m["skipped"] == 0.0 and np.isfinite(m["loss"]) for m in metrics),
              f"rest {name}: steps {metrics}")
        if name == "ema_restart_dropout":
            dead = int((tr.model.pq_state.vq_count == 0).sum())
            new = tr.forward_backward(batches[1])[1]["state"]
            step_dead = int((new["pq_state.vq_count"] - tr.model.pq_state.vq_count == 0).sum())
            reset = float(new["pq_state.ema_count"].abs().sum()) == 0.0
            check(reset == (step_dead > 0), f"rest {name}: {step_dead} dead, counts reset {reset}")
            extra.update(never_used_codewords=dead, dead_in_step=step_dead, counts_reset=reset)
        emit({"phase": "rest", "what": "quantizer_option", "config": name, "batch": 16,
              "ms_per_step": [1e3 * t for t in times], "losses": [m["loss"] for m in metrics],
              "codebook_usage": [m["codebook-usage"] for m in metrics],
              "launches_per_step": {k: v / 2 for k, v in counts.items()}, **extra})
        del tr
        torch.cuda.empty_cache()


def phase_rest(results: dict) -> None:
    """The last single-device slice at the preset's full width
    (``rest_visualize``, ``rest_cli_profile``, ``rest_cache``,
    ``rest_backbone``, ``rest_quantizer_options``)."""
    rest_visualize(results)
    rest_cli_profile(results)
    rest_cache(results)
    rest_backbone(results)
    rest_quantizer_options(results)


# ------------------------------------------------ the registry's baselines

def preset_trainer(name: str, device: str = "cuda", dropout: bool = True):
    """(config, Trainer) of ``preset(name)``, built through the registry,
    weights from seed 0."""
    from equss_tpu_torch.train.trainer import Trainer

    cfg = preset(name)
    cfg["model"]["pretrained"]["dropout"] = dropout
    return cfg, Trainer(cfg, device=device, seed=0)


def timed_train(tr, batches: list, warm: int, per_step: dict, path: str,
                results: dict) -> tuple:
    """Train steps on ``batches``: ``warm`` untimed, the rest timed (host
    clock to the synchronised end, the batch's copy included) with every
    launch counted from 0 and held to ``per_step`` per step; every metric
    finite and no step skipped.  Returns (metrics, timing row)."""
    from equss_tpu_torch import launch_counts, reset_launch_counts

    times, metrics = [], []
    for i, batch in enumerate(batches):
        if i == warm:
            reset_launch_counts()
        t0 = time.perf_counter()
        metrics.append(tr.train_step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    timed = len(batches) - warm
    results["launches"][path] = counts
    check(counts == expected(per_step, timed), f"{path}: launches {counts}")
    check(all(np.isfinite(v) for m in metrics for v in m.values())
          and not any(m["skipped"] for m in metrics), f"{path}: non-finite step")
    t = sorted(times[warm:])
    return metrics, {"steps_timed": timed, "ms_per_step_median": 1e3 * t[timed // 2],
                     "ms_per_step_min": 1e3 * t[0],
                     "launches_per_step": {k: v / timed for k, v in counts.items()}}


def timed_validate(tr, batches: list, warm: int, per_step: dict, path: str,
                   results: dict) -> tuple:
    """``Trainer.validate`` over ``batches[warm:]`` after ``warm`` valid
    steps, launches counted from 0 and held to ``per_step`` per valid step,
    the metrics finite and in [0, 100]; then each valid step timed alone.
    Returns (metrics, the last step's result, timing row)."""
    from equss_tpu_torch import launch_counts, reset_launch_counts

    for b in batches[:warm]:
        tr.valid_step(b)
    torch.cuda.synchronize()
    reset_launch_counts()
    val = tr.validate(batches[warm:])
    counts = launch_counts()
    steps = len(batches) - warm
    results["launches"][path] = counts
    check(counts == expected(per_step, steps), f"{path}: launches {counts}")
    check_valid_metrics(val, path)
    times = []
    for b in batches[warm:]:
        t0 = time.perf_counter()
        res = tr.valid_step(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = sorted(times)
    return val, res, {"batches": steps, "ms_per_valid_step_median": 1e3 * t[steps // 2],
                      "ms_per_valid_step_min": 1e3 * t[0],
                      "launches_per_valid_step": {k: v / steps for k, v in counts.items()}}


def phase_vq(results: dict) -> None:
    """``configs/vq_cocostuff27.yaml`` at full width (ViT-S/8, bf16, head
    to 1024, an EMA codebook of K = 256 words of d = 1024, fast
    assignments): 8 train steps at b = 16 (+16 positives) on 224^2 after
    2 warm-up ones (12 attention launches each: EMA training takes the
    distance softmax's route, as in JAX), the EMA state moved and ``jsd``,
    ``entropy`` and ``vq-loss`` finite; ``validate`` over 4 batches of
    b = 8 at 320^2 (12 attention and 1 PQ launch per valid step, the PQ
    kernel's wide body at n = 12 800); the predictor at b = 128 on 224^2
    (12 + 1 launches per request, the wide body at n = 100 352); profiles;
    then the same valid and predictor runs with ``model.vq.assign_precision:
    exact`` (the JAX default), on the exact wide body.
    ``phase_vq_reference`` holds a train step against the CPU."""
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.train.trainer import Trainer

    _, tr = preset_trainer("vq_cocostuff27")
    before = {k: v.clone() for k, v in tr.model.pq_state.as_dict().items()}
    batches = list(synthetic_batches(11, 10, 16, res=224, num_classes=27))
    metrics, timing = timed_train(tr, batches, 2, STOCK_TRAIN_KERNELS, "vq_train", results)
    after = tr.model.pq_state.as_dict()
    moved = {k: (after[k] - v).abs().max().item() for k, v in before.items()}
    check(all(v > 0 for v in moved.values()), f"vq train: EMA state did not move {moved}")
    check(all(np.isfinite(m[k]) for m in metrics for k in ("jsd", "entropy", "vq-loss")),
          "vq train: jsd, entropy or vq-loss not finite")
    emit({"phase": "vq", "what": "train", "batch": 16, **timing, "ema_state_max_change": moved,
          **{f"{k}_per_step": [m[k] for m in metrics]
             for k in ("loss", "stego-loss", "vq-loss", "jsd", "entropy", "codebook-usage")}})
    cycle = iter(batches * 2)
    emit({"phase": "profile", "what": "vq_train", "batch": 16, "steps": 2,
          **device_profile(lambda: tr.train_step(next(cycle)), 2,
                           pick=KERNEL_PICK + ("index", "softmax"))})

    vq_valid_and_serve(tr, "vq", results)
    del tr
    torch.cuda.empty_cache()

    # the exact sub-run: the JAX default assign_precision, the exact wide body
    cfg = with_overrides(preset("vq_cocostuff27"), {"model.vq.assign_precision": "exact"})
    tr = Trainer(cfg, device="cuda", seed=0)
    vq_valid_and_serve(tr, "vq_exact", results, exact=True)
    del tr
    torch.cuda.empty_cache()


def wide_in_path(prof: dict, n: int, exact: bool, what: str) -> dict:
    """``pq_in_path`` for the VQ baseline's wide launch (all its kernels,
    1 x 256 x 1024); the profile must name the mode's body,
    ``pq_wide_exact_kernel`` or ``pq_wide_fast_kernel``."""
    return pq_in_path(prof, n, (1, 256, 1024), exact,
                      "pq_wide_exact_kernel" if exact else "pq_wide_fast_kernel", "pq_wide",
                      what)


def wide_launch_groups(sequence: list) -> list:
    """The device ms of each wide-body launch in a profile's ``sequence``
    of ``pq_wide`` kernels: a launch is the pre-pass, the distance body
    and the gather pass, or the fused body alone."""
    groups, open_group = [], None
    for name, ms in sequence:
        if "prep" in name:
            open_group = [ms]
            groups.append(open_group)
        elif open_group is not None:
            open_group.append(ms)
            if "gather" in name:
                open_group = None
        else:
            groups.append([ms])
    return [sum(g) for g in groups]


def wide_launches_in_path(prof: dict, launches: list, images: int, what: str,
                          isolated: dict) -> dict:
    """Each wide launch of a step (``launches``: ((M, K, d), exact, rows
    per image) in the order they run) in a profile of ``prof["calls"]``
    steps with the ``pq_wide`` ``sequence``: its device ms (mean over the
    steps), its bound and share of it at its n, and the isolated time of
    the same body at the same n (``isolated``, phase ``pq_wide``; whether
    it runs fused); the profile must name the mode's body."""
    ms = wide_launch_groups(prof.pop("sequence"))
    check(len(ms) == len(launches) * prof["calls"],
          f"{what}: {len(ms)} wide launches in the profile, not "
          f"{len(launches) * prof['calls']}")
    out = []
    for i, (shape, exact, rows) in enumerate(launches):
        n = images * rows
        row = pq_in_path(prof, n, shape, exact,
                         "pq_wide_exact_kernel" if exact else "pq_wide_fast_kernel", "pq_wide",
                         what)
        mine = ms[i::len(launches)]
        row["pq_wide_ms_per_launch"] = sum(mine) / max(len(mine), 1)
        row["pq_wide_share_of_bound"] = row["pq_wide_bound_ms"] / row["pq_wide_ms_per_launch"]
        iso = isolated.get((shape, exact, n))
        check(iso is not None, f"{what}: no isolated row of {shape} at n = {n}")
        out.append({"shape": list(shape), "exact": exact, "n": n, **row,
                    "fused": None if iso is None else iso["launch"]["fused"],
                    "isolated_ms": None if iso is None else iso["ms"],
                    "in_path_over_isolated": (None if iso is None else
                                              row["pq_wide_ms_per_launch"] / iso["ms"])})
    return {"wide_launches": out}


def vq_valid_and_serve(tr, tag: str, results: dict, exact: bool = False) -> None:
    """``validate`` over 4 batches of b = 8 at 320^2 after 2 warm-up steps
    (12 attention and 1 PQ launch per valid step, the PQ kernel's wide body
    at n = 12 800), then the predictor at b = 128 on 224^2 (12 + 1 launches
    per request, the wide body at n = 100 352), each with a profile that
    names the wide launch's device ms and share of bound in path; launch
    counts under ``<tag>_valid`` and ``<tag>_serve``."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch import serve as port_serve

    vb = valid_batches(6, 8, seed=330)
    val, res, timing = timed_validate(tr, vb, 2, SERVE_KERNELS, f"{tag}_valid", results)
    check(tuple(res["pq_indices"].shape) == (8, 40, 40, 1), f"{tag} valid: index shape")
    emit({"phase": "vq", "what": "valid", "assign_precision": "exact" if exact else "bf16",
          "batch": 8, "res": 320, **timing, **val})
    cycle = iter(vb * 2)
    prof = device_profile(lambda: tr.valid_step(next(cycle)), 2, pick=KERNEL_PICK)
    emit({"phase": "profile", "what": f"{tag}_valid", "batch": 8, "res": 320, "steps": 2,
          **prof, **wide_in_path(prof, 8 * 40 * 40, exact, f"{tag} valid")})

    predict = port_serve.build_predict_fn(tr)
    reqs = requests(128, 5, seed=1282)
    reset_launch_counts()
    times = []
    for req in reqs:
        t0 = time.perf_counter()
        out = predict(req.to("cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(all(tuple(v.shape) == (128, 224, 224) and v.dtype == torch.int32
                  and bool(((v >= 0) & (v < 27)).all()) for v in out.values()),
              f"{tag} serve: predictions")
    counts = launch_counts()
    results["launches"][f"{tag}_serve"] = counts
    check(counts == expected(SERVE_KERNELS, len(reqs)), f"{tag} serve: launches {counts}")
    t = sorted(times[2:])
    emit({"phase": "vq", "what": "serve", "assign_precision": "exact" if exact else "bf16",
          "batch": 128, "requests_timed": len(t),
          "ms_per_request_median": 1e3 * t[len(t) // 2], "img_per_s": 128 / t[len(t) // 2],
          "launches_per_request": {k: v / len(reqs) for k, v in counts.items()}})
    img = reqs[0].to("cuda")
    prof = device_profile(lambda: predict(img), 2, pick=KERNEL_PICK)
    emit({"phase": "profile", "what": f"{tag}_serve", "batch": 128, "forwards": 2,
          **prof, **wide_in_path(prof, 128 * 28 * 28, exact, f"{tag} serve")})


def phase_vq_reference() -> None:
    """One ``vq_cocostuff27`` train step at b = 2, dropout off, on the card
    against the CPU (``reference_step``): at the preset's codebook, then
    at a codebook of 256 of the CPU's own codes."""
    from equss_tpu_torch.data.synthetic import synthetic_batches

    batch = stego_samples(next(synthetic_batches(8, 1, 2, res=224, num_classes=27)), 8)
    # at the preset's initial codebook (uniform in +-1/256) the bf16
    # distances of d = 1024 codes (|z|^2 ~ 1.6e3, one bf16 ulp 8) to the
    # 256 codewords tie at the minimum in nearly every pixel, and the first
    # tied index wins: the end-to-end agreement follows the bf16 rounding
    # of |z|^2, not the port, so it is held on the untied pairs only (none
    # may be left) and the quantizer is held on the card's own code
    row = reference_step(lambda device: preset_trainer("vq_cocostuff27", device, False)[1],
                         batch, {"head": "head."}, "vq train reference", e2e_bar=False)
    emit({"phase": "train_reference_cpu", "config": "vq_cocostuff27", **row})
    # the same step with a codebook of 256 of the CPU's own codes (a data
    # initialisation: codewords spread as the codes are), where the minima
    # are untied and the end-to-end bar holds most pairs
    _, tr0 = preset_trainer("vq_cocostuff27", "cpu", False)
    code = tr0.forward_backward(batch)[1]["code"].detach().reshape(-1, 1024)
    pick = torch.randperm(code.shape[0], generator=torch.Generator().manual_seed(8))[:256]
    data_cb = code[pick].reshape(1, 256, 1024).clone()
    del tr0, code

    def data_trainer(device):
        tr = preset_trainer("vq_cocostuff27", device, False)[1]
        for name in ("ema_weight", "ema_weight_avg"):
            getattr(tr.model.pq_state, name).copy_(data_cb)
        return tr

    row = reference_step(data_trainer, batch, {"head": "head."},
                         "vq train reference, data codebook", e2e_bar=False)
    check(row["untied_pairs"] > 0, "vq train reference, data codebook: no untied pair")
    emit({"phase": "train_reference_cpu", "config": "vq_cocostuff27", "codebook": "data",
          **row})


def phase_stego(results: dict) -> None:
    """STEGO at the presets' widths: ``stego_cocostuff27`` (ViT-S/8, head
    to 70) with 6 train steps at b = 16 (+16) on 224^2 after 2 warm-up and
    ``validate`` over 4 batches of b = 8 at 320^2; ``stego_pascal`` (ViT-B/8,
    attention at (128, 785, 2304) in a step) with 4 train steps at b = 64
    (+64) after 2 and ``validate`` over 2 batches of b = 32 at 320^2
    ((32, 1601, 2304)); 12 attention launches per step and per valid
    step; profiles of the Pascal steps; then one stego_cocostuff27 train
    step at b = 2 on the card against the CPU (``reference_step``)."""
    from equss_tpu_torch.data.synthetic import synthetic_batches

    for name, bs, vbs, timed, vsteps in (("stego_cocostuff27", 16, 8, 6, 4),
                                         ("stego_pascal", 64, 32, 4, 2)):
        cfg, tr = preset_trainer(name)
        ncls = cfg["num_classes"]
        torch.cuda.reset_peak_memory_stats()
        batches = list(synthetic_batches(12, 2 + timed, bs, res=224, num_classes=ncls))
        metrics, timing = timed_train(tr, batches, 2, STOCK_TRAIN_KERNELS,
                                      f"{name}_train", results)
        emit({"phase": "stego", "config": name, "what": "train", "batch": bs, **timing,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              **{f"{k}_per_step": [m[k] for m in metrics]
                 for k in ("loss", "stego-loss", "linear-loss", "cluster-loss")}})
        vb = valid_batches(2 + vsteps, vbs, seed=340, num_classes=ncls)
        val, res, timing = timed_validate(tr, vb, 2, STOCK_TRAIN_KERNELS, f"{name}_valid",
                                          results)
        check(tuple(res["linear_preds"].shape) == (vbs, 320, 320), f"{name} valid: shapes")
        emit({"phase": "stego", "config": name, "what": "valid", "batch": vbs, "res": 320,
              **timing, **val})
        if name == "stego_pascal":
            cycle = iter(batches * 2)
            emit({"phase": "profile", "what": "stego_pascal_train", "batch": bs, "steps": 2,
                  **device_profile(lambda: tr.train_step(next(cycle)), 2, pick=KERNEL_PICK)})
            vcycle = iter(vb * 2)
            emit({"phase": "profile", "what": "stego_pascal_valid", "batch": vbs, "res": 320,
                  "steps": 2,
                  **device_profile(lambda: tr.valid_step(next(vcycle)), 2, pick=KERNEL_PICK)})
        del tr
        torch.cuda.empty_cache()

    batch = stego_samples(next(synthetic_batches(9, 1, 2, res=224, num_classes=27)), 9)
    row = reference_step(lambda device: preset_trainer("stego_cocostuff27", device, False)[1],
                         batch, {"head": "head."}, "stego train reference")
    emit({"phase": "train_reference_cpu", "config": "stego_cocostuff27", **row})


def phase_baselines(results: dict) -> None:
    """``cluster_baseline`` (probes on the frozen ViT-S/8 features: no
    trainable model parameter, a zero gradient norm) and ``sl_cocostuff27``
    (supervised: the linear probe's cross-entropy trains the head, no
    cluster probe, the Cluster keys repeating the Linear ones): 4 train
    steps at b = 16 after 2 and ``validate`` over 2 batches of b = 8 at
    320^2, 12 attention launches per step and per valid step."""
    from equss_tpu_torch.data.synthetic import synthetic_batches

    for name in ("cluster_baseline", "sl_cocostuff27"):
        _, tr = preset_trainer(name)
        batches = list(synthetic_batches(13, 6, 16, res=224, num_classes=27))
        metrics, timing = timed_train(tr, batches, 2, STOCK_TRAIN_KERNELS, f"{name}_train",
                                      results)
        val, _, vtiming = timed_validate(tr, valid_batches(4, 8, seed=350), 2,
                                         STOCK_TRAIN_KERNELS, f"{name}_valid", results)
        if name == "cluster_baseline":
            check(not tr.model_params and all(m["grad-norm"] == 0.0 for m in metrics),
                  "cluster_baseline: trainable model parameters")
        else:
            check(tr.evaluator.cluster_probe is None
                  and not any("cluster-loss" in m for m in metrics)
                  and all(m["grad-norm"] > 0.0 for m in metrics)
                  and val["Cluster_mIoU"] == val["Linear_mIoU"],
                  f"sl: supervised run {metrics[-1]}, {val}")
        emit({"phase": "baselines", "config": name, "batch": 16, **timing,
              "valid": {**vtiming, **val},
              **{f"{k}_per_step": [m[k] for m in metrics]
                 for k in ("loss", "linear-loss", "grad-norm")}})
        del tr
        torch.cuda.empty_cache()


def phase_cli_baselines(results: dict) -> None:
    """``cli.run`` on ``stego_cocostuff27`` and ``vq_cocostuff27`` (dict
    configs), synthetic data, 4 train steps at b = 16, one val batch of
    b = 8 at 320^2, validation every 2 steps, a final CRF of one mean-field
    iteration (the preset's CLI phase runs the full one): logged steps,
    checkpoints, ``final_*`` and ``final_crf_*`` in [0, 100], and the
    launches of each run counted from 0 (STEGO 12 attention per step and
    per valid step; VQ adds 1 PQ per valid step).  Then the STEGO run's
    checkpoint exported as a pinned b = 8 artifact at 320^2
    (``serve.export_predictor``), loaded with ``load_predictor`` and held
    against the live predictor (>= 99.99% of pixels equal, 12 attention
    launches per request; ms per request artifact vs live in turns)."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch import serve as port_serve
    from equss_tpu_torch.cli import run
    from equss_tpu_torch.core.checkpoint import CheckpointManager
    from equss_tpu_torch.core.config import resolve_config

    root = tempfile.mkdtemp(prefix="equss_cli_baselines_")
    try:
        ckpts = {}
        for name, per_valid in (("stego_cocostuff27", STOCK_TRAIN_KERNELS),
                                ("vq_cocostuff27", SERVE_KERNELS)):
            cfg = resolve_config(with_overrides(preset(name), {
                "dataset.synthetic": True, "dataset.synthetic_batches": 4,
                "train.max_epochs": 1, "train.valid_interval_iters": 2,
                "train.print_interval_iters": 1, "eval.crf": {"max_iter": 1},
                "save_dir": f"{root}/{name}"}))
            cfg["debug"] = True
            reset_launch_counts()
            t0 = time.perf_counter()
            out = run(cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = launch_counts()
            path = f"cli_{name.split('_')[0]}"
            results["launches"][path] = counts
            (run_dir,) = [os.path.join(root, name, d) for d in os.listdir(os.path.join(root, name))]
            records = read_metrics(run_dir)
            logged = [r["step"] for r in records if "final_Cluster_mIoU" not in r
                      and "final_crf_Cluster_mIoU" not in r]
            final = next(r for r in records if "final_Cluster_mIoU" in r)
            final_crf = next((r for r in records if "final_crf_Cluster_mIoU" in r), {})
            ckpts[name] = os.path.join(run_dir, "ckpt")
            saved = sorted(int(d) for d in os.listdir(ckpts[name]))
            check(logged == [1, 2, 2, 3, 4, 4, 4], f"{path}: logged steps {logged}")
            check(bool(saved) and final["step"] == saved[-1],
                  f"{path}: checkpoints {saved}, final eval at step {final['step']}")
            keys = ("Cluster_mIoU", "Cluster_Accuracy", "Linear_mIoU", "Linear_Accuracy")
            check(all(0.0 <= final.get(f"final_{k}", -1.0) <= 100.0
                      and 0.0 <= final_crf.get(f"final_crf_{k}", -1.0) <= 100.0 for k in keys),
                  f"{path}: final metrics {final} {final_crf}")
            train_l, valid_l = expected(STOCK_TRAIN_KERNELS, 4), expected(per_valid, 5)
            want = {k: train_l[k] + valid_l[k] for k in train_l}
            check(counts == want, f"{path}: launches {counts}, expected {want}")
            steps = [r for r in records if "loss" in r]
            emit({"phase": "cli", "run": name, "wall_seconds": seconds, "logged_steps": logged,
                  "checkpoint_steps": saved, "best": out["best"], "launches": counts,
                  "final": {k: v for k, v in final.items() if k != "step"},
                  "final_crf": {k: v for k, v in final_crf.items() if k != "step"},
                  "losses": {r["step"]: r["loss"] for r in steps}})
            check(all(np.isfinite(r["loss"]) for r in steps), f"{path}: non-finite loss")

        _, tr = preset_trainer("stego_cocostuff27")
        tr.load_train_state(CheckpointManager(ckpts["stego_cocostuff27"]).restore(),
                            resume_training=False)
        t0 = time.perf_counter()
        exported = port_serve.export_predictor(tr, (320, 320), batch_size=8,
                                               symbolic_batch="off")
        art = port_serve.save_predictor(exported, os.path.join(root, "stego.pt2"))
        export_seconds = time.perf_counter() - t0
        artifact = port_serve.load_predictor(art)
        live = port_serve.build_predict_fn(tr)
        img = valid_batches(1, 8, seed=360)[0]["img"]
        x = torch.from_numpy(img).cuda().float() / 255.0
        reset_launch_counts()
        got = artifact(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        results["launches"]["export_stego"] = counts
        ref = live(x)
        agree = min((got[k] == ref[k]).float().mean().item() for k in ref)
        check(set(got) == set(ref) and agree >= 0.9999, f"export stego: agreement {agree}")
        check(counts == expected(STOCK_TRAIN_KERNELS, 1), f"export stego: launches {counts}")
        times = {"artifact": [], "live": []}
        for name in ("artifact", "live") * 2 + ("live", "artifact") * 2:
            fn = artifact if name == "artifact" else live
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
        emit({"phase": "export", "config": "stego_cocostuff27", "batch": 8, "res": 320,
              "export_seconds": export_seconds, "artifact_bytes": os.path.getsize(art),
              "pixel_agreement": agree, "launches_per_request": counts,
              **{f"{k}_ms_median": 1e3 * sorted(v)[len(v) // 2] for k, v in times.items()}})
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------- the own-data path

CORPUS_SPLITS = (("train2017", 64), ("val2017", 16))
CORPUS_HW = (480, 640)          # COCO's usual image size
KNN_BATCH = 32                  # precompute_knns' batch, at the preset's 224^2


def write_corpus(root: str, seed: int = 0) -> None:
    """A miniature COCO-Stuff corpus in its on-disk layout (``images/``,
    ``annotations/`` and the ``curated/`` file lists of train2017 and
    val2017): 480 x 640 JPEG images of flat colour cells, each image with
    its own cell size and colours from ``seed``, and PNG fine labels
    constant per cell with an ignore band (255)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    H, W = CORPUS_HW
    for split, n in CORPUS_SPLITS:
        for sub in ("images", "annotations", "curated"):
            os.makedirs(os.path.join(root, sub, split))
        ids = []
        for i in range(n):
            img_id = f"{split[:-4]}_{i:06d}"
            ids.append(img_id)
            ch, cw = (int(v) for v in rng.randint(24, 121, size=2))
            gh, gw = -(-H // ch), -(-W // cw)
            cells = lambda a: np.repeat(np.repeat(a, ch, 0), cw, 1)[:H, :W]  # noqa: E731
            img = cells(rng.randint(0, 256, (gh, gw, 3)).astype(np.uint8))
            label = np.ascontiguousarray(cells(rng.randint(0, 182, (gh, gw)).astype(np.uint8)))
            top = rng.randint(0, H - 48)
            label[top:top + 48] = 255
            Image.fromarray(np.ascontiguousarray(img)).save(
                os.path.join(root, "images", split, img_id + ".jpg"), quality=90)
            Image.fromarray(label).save(os.path.join(root, "annotations", split, img_id + ".png"))
        for name in ("Coco164kFull_Stuff_Coarse.txt", "Coco164kFull_Stuff_Coarse_7.txt",
                     "Coco164kFew_Stuff_6.txt"):
            with open(os.path.join(root, "curated", split, name), "w") as f:
                f.write("\n".join(ids) + "\n")


def corpus_args(root: str) -> list:
    """``cli.main``'s arguments for the preset on the corpus at ``root``."""
    return ["--config", os.path.join(REPO, "configs", "pqgo_cocostuff27.yaml"), "--debug",
            f"data_dir={root}", f"save_dir={os.path.join(root, 'runs')}"]


def corpus_config(root: str, *overrides: str) -> dict:
    from equss_tpu_torch.core.config import prepare_config

    return prepare_config([*corpus_args(root), *overrides])[0]


def batches_equal(a: dict, b: dict) -> bool:
    """Two host batches hold the same keys, arrays of one dtype and equal
    elements, and equal lists."""
    if sorted(a) != sorted(b):
        return False
    for k, x in a.items():
        y = b[k]
        if isinstance(x, np.ndarray):
            if not (isinstance(y, np.ndarray) and x.dtype == y.dtype and np.array_equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def phase_crop(root: str) -> None:
    """The corpus, then the crop job through ``cli.main``: 5 crops of half
    the height and width of each of the 64 train images."""
    import PIL
    from PIL import Image

    from equss_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    write_corpus(root)
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = cli_main(["crop", *corpus_args(root)])
    crop_s = time.perf_counter() - t0
    n_img = len(os.listdir(os.path.join(out, "img", "train")))
    n_label = len(os.listdir(os.path.join(out, "label", "train")))
    with Image.open(os.path.join(out, "img", "train", "0.jpg")) as im:
        size = im.size
    want = 5 * CORPUS_SPLITS[0][1]
    check(n_img == n_label == want and size == (CORPUS_HW[1] // 2, CORPUS_HW[0] // 2),
          f"crop: {n_img} images and {n_label} labels of size {size}, expected {want}")
    emit({"phase": "data", "job": "crop", "pil": PIL.__version__,
          "corpus": {s: n for s, n in CORPUS_SPLITS}, "image_hw": CORPUS_HW,
          "corpus_seconds": corpus_s, "crop_seconds": crop_s, "crops": n_img,
          "crop_wh": list(size)})


def phase_knn(results: dict, root: str) -> None:
    """The kNN job through ``cli.main`` on the 320 crops at 224^2, b = 32:
    10 feature batches and 120 attention launches at (32, 785, 1152),
    counted from 0; every crop its own first neighbour.  Then the same
    model's pooled features again on the card (their wall and device-only
    rates), against the CPU's on the first batch (mean relative error
    <= 2e-2, the serving class), and the job's top-k against ``torch.topk``
    on the CPU over the card's own features wherever neighbouring
    similarities are more than 1e-3 apart."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.cli import main as cli_main
    from equss_tpu_torch.data import jobs
    from equss_tpu_torch.data.pipeline import UnSegData
    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.models import vit
    from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig

    batches, shapes = [], []
    plain_features, plain_attention = EQUSS.features, vit.attention_qkv

    def features(self, img):
        batches.append(int(img.shape[0]))
        return plain_features(self, img)

    def attention(qkv, *args, **kwargs):
        shapes.append(tuple(qkv.shape))
        return plain_attention(qkv, *args, **kwargs)

    EQUSS.features, vit.attention_qkv = features, attention
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        path = cli_main(["knn", *corpus_args(root)])
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        EQUSS.features, vit.attention_qkv = plain_features, plain_attention
    results["launches"]["knn"] = counts
    n = 5 * CORPUS_SPLITS[0][1]
    n_batches = -(-n // KNN_BATCH)
    check(batches == [KNN_BATCH] * n_batches and counts == expected({"attention_qkv": 12},
                                                                    n_batches)
          and set(shapes) == {(KNN_BATCH, 785, 1152)},
          f"knn: feature batches {batches}, launches {counts}, shapes {set(shapes)}")
    nns = np.load(path)["nns"]
    check(nns.shape == (n, 30) and bool((nns[:, 0] == np.arange(n)).all()),
          f"knn: nns {nns.shape}, own first neighbour for {(nns[:, 0] == np.arange(n)).sum()}")

    cfg = corpus_config(root)
    d = cfg["dataset"]["train"]
    data = UnSegData(mode="train", data_dir=d["data_dir"], dataset_name=d["dataset_name"],
                     model_type=d["model_type"], crop_type=d["crop_type"],
                     crop_ratio=d["crop_ratio"], loader_crop_type=d["loader_crop_type"],
                     res=d["res"], pos_images=False, seed=cfg["seed"])
    model = EQUSS(EQUSSConfig.from_config(cfg), device="cuda", seed=cfg["seed"])
    t0 = time.perf_counter()
    feats = jobs.extract_pooled_features(model, data, batch_size=KNN_BATCH)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    img = normalize_images(torch.from_numpy(
        next(data.batches(KNN_BATCH, shuffle=False, drop_last=False))["img"]).cuda())
    with torch.no_grad():
        device_ms = cuda_ms(lambda: model.features(img).mean(dim=(1, 2)), iters=5)
    model_c = EQUSS(EQUSSConfig.from_config(cfg), device="cpu", seed=cfg["seed"])
    t0 = time.perf_counter()
    feats_c = jobs.extract_pooled_features(model_c, data, batch_size=KNN_BATCH,
                                           max_items=KNN_BATCH)
    cpu_s = time.perf_counter() - t0
    f = feats.cpu()
    rel = ((f[:KNN_BATCH] - feats_c).abs().mean() / feats_c.abs().mean()).item()
    check(rel <= 2e-2, f"knn: pooled features card vs CPU, mean rel err {rel}")

    nns_cpu = jobs.topk_neighbors(f, 30)
    sim = torch.sort(f @ f.T, dim=1, descending=True).values[:, :31]
    gaps = (sim[:, :-1] - sim[:, 1:]).numpy()                    # rank r to r + 1
    decided = (np.concatenate([np.full((n, 1), np.inf), gaps[:, :-1]], 1) > 1e-3) & (gaps > 1e-3)
    topk_equal = bool((nns[decided] == nns_cpu[decided]).all())
    check(decided.any() and topk_equal,
          f"knn: top-k against the CPU's on {int(decided.sum())} decided ranks: {topk_equal}")
    emit({"phase": "knn", "items": n, "batch": KNN_BATCH, "res": d["res"],
          "feature_batches": len(batches), "attention_shapes": sorted(set(shapes)),
          "launches": counts, "job_wall_seconds": wall,
          "extract_seconds": extract_s, "extract_img_per_s": n / extract_s,
          "features_device_ms_per_batch": device_ms,
          "features_img_per_s_device": KNN_BATCH * 1e3 / device_ms,
          "feat_mean_rel_err_vs_cpu": rel, "cpu_first_batch_seconds": cpu_s,
          "ranks_decided": float(decided.mean()), "topk_equal_where_decided": topk_equal,
          "job_equals_recomputed_topk": bool((jobs.topk_neighbors(feats, 30) == nns).all()),
          "own_first_neighbour": bool((nns[:, 0] == np.arange(n)).all())})


def pipeline_rate(data, batch: int, seed: int) -> dict:
    """One epoch of ``data``'s batches on the host: seconds and images per
    second (positives counted)."""
    t0 = time.perf_counter()
    count = n = 0
    for b in data.batches(batch, seed=seed):
        count += 1
        n += len(b["img"]) + len(b.get("img_pos", ()))
    seconds = time.perf_counter() - t0
    return {"batches": count, "images": n, "seconds": seconds, "img_per_s": n / seconds}


def phase_pack(root: str) -> None:
    """The pack job through ``cli.main`` (both splits); the first two
    batches of each split from the pack equal to those decoded from the
    files (train with its kNN positives); then the host pipeline's rate
    over one train epoch by decode path: PIL, the pack and, where its
    library builds, the native loader."""
    from equss_tpu_torch.cli import main as cli_main
    from equss_tpu_torch.data import native_loader
    from equss_tpu_torch.data.pipeline import build_data

    t0 = time.perf_counter()
    packs = cli_main(["pack", *corpus_args(root)])
    pack_s = time.perf_counter() - t0
    check(len(packs) == 2, f"pack: wrote {packs}")
    cfg = corpus_config(root)
    seed = cfg["seed"]

    def data(mode, path):
        c = with_overrides(cfg, {f"dataloader.{mode}.pack": "on" if path == "pack" else "off",
                                 f"dataloader.{mode}.native": "on" if path == "native" else "off"})
        return build_data(c, mode, seed=seed)

    equal = {}
    for mode, bs, kw in (("train", 16, {"seed": seed}),
                         ("val", 8, {"shuffle": False, "drop_last": False})):
        packed, files = data(mode, "pack"), data(mode, "PIL")
        check(packed._fast_batch_kind() == "pack", f"pack: {mode} does not read the pack")
        a = [b for _, b in zip(range(2), packed.batches(bs, **kw))]
        b = [b for _, b in zip(range(2), files.batches(bs, **kw))]
        equal[mode] = len(a) == len(b) > 0 and all(map(batches_equal, a, b))
        check(equal[mode], f"pack: the {mode} batches from the pack differ from the files'")
    rates = {path: pipeline_rate(data("train", path), 16, seed) for path in ("PIL", "pack")}
    native = {"available": native_loader.available()}
    if native["available"]:
        rates["native"] = pipeline_rate(data("train", "native"), 16, seed)
    else:
        native["why"] = str(native_loader._load_error).strip().splitlines()[-1][:200]
    emit({"phase": "data", "job": "pack", "pack_seconds": pack_s,
          "packs": [os.path.basename(p) for p in packs],
          "first_two_batches_equal_files": equal, "decode_threads": data("train", "PIL").num_workers,
          "train_epoch_by_decode_path": rates, "native": native})


def run_dir_of(save_dir: str) -> str:
    (name,) = os.listdir(save_dir)
    return os.path.join(save_dir, name)


def phase_train_files(results: dict, root: str) -> str:
    """``cli.run`` on the corpus: the preset for one epoch of the 320 crops
    (20 steps at b = 16 with kNN positives), a log every step, validation
    every 10 steps on the 16 val images at 320^2, b = 8, no final CRF.
    Train and valid steps and the decode paths are recorded as they run,
    each train step timed as the train phase times one (host clock between
    synchronisations; ``iter_time``, the logged time per step, adds the
    wait for the batch and the validations); launches counted from 0 (12
    attention per train step, 12 + 1 per valid step).  Returns the run's
    checkpoint directory."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.cli import run
    from equss_tpu_torch.data.pipeline import UnSegData
    from equss_tpu_torch.train.trainer import Trainer

    cfg = corpus_config(root, "train.max_epochs=1", "train.valid_interval_iters=10",
                        "train.print_interval_iters=1", "eval.final_crf=false")
    calls = {"train": 0, "valid": 0}
    decode, step_times = {}, []
    plain = Trainer.train_step, Trainer.valid_step, UnSegData._fast_batch_kind

    def train_step(self, batch):
        calls["train"] += 1
        check("img_pos" in batch, "train_files: a train batch without kNN positives")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain[0](self, batch)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        return out

    def valid_step(self, batch):
        calls["valid"] += 1
        return plain[1](self, batch)

    def fast_batch_kind(self):
        kind = plain[2](self)
        decode[self.mode] = kind or "PIL"
        return kind

    Trainer.train_step, Trainer.valid_step, UnSegData._fast_batch_kind = (
        train_step, valid_step, fast_batch_kind)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        Trainer.train_step, Trainer.valid_step, UnSegData._fast_batch_kind = plain
    results["launches"]["train_files"] = counts
    run_dir = run_dir_of(cfg["save_dir"])
    records = read_metrics(run_dir)
    steps = [r["step"] for r in records if "loss" in r]
    final = next((r for r in records if "final_Cluster_mIoU" in r), {})
    iter_times = sorted(r["iter_time"] for r in records if "iter_time" in r)
    train_l, valid_l = (expected(STOCK_TRAIN_KERNELS, calls["train"]),
                        expected(SERVE_KERNELS, calls["valid"]))
    want = {k: train_l[k] + valid_l[k] for k in counts}
    check(calls["train"] == 20 and steps == list(range(1, 21)) and counts == want,
          f"train_files: {calls} steps, logged {steps}, launches {counts}, expected {want}")
    check(0.0 <= final.get("final_Cluster_mIoU", -1.0) <= 100.0
          and all(np.isfinite(r["loss"]) for r in records if "loss" in r),
          f"train_files: final {final}")
    emit({"phase": "train_files", "train_steps": calls["train"], "valid_steps": calls["valid"],
          "decode": decode, "logged_steps": steps, "wall_seconds": wall,
          "step_ms_median": 1e3 * sorted(step_times)[len(step_times) // 2],
          "step_ms_min": 1e3 * min(step_times),
          "iter_time_ms_median": 1e3 * iter_times[len(iter_times) // 2],
          "synthetic_stock_step_ms_median": results.get("stock_step_ms_median"),
          "launches": counts,
          "launches_per_train_step": {k: v / calls["train"] for k, v in train_l.items()},
          "final_Cluster_mIoU": final.get("final_Cluster_mIoU"),
          "final_Linear_mIoU": final.get("final_Linear_mIoU"), "best": out["best"]})
    return os.path.join(run_dir, "ckpt")


_LOAD_ONLY = """
import json, sys, torch
from equss_tpu_torch.serve import load_predictor
from equss_tpu_torch.ops import launch_counts
predict = load_predictor(sys.argv[1])
out = predict(torch.load(sys.argv[2]))
torch.cuda.synchronize()
torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[3])
print(json.dumps({"launches": launch_counts(), "model_modules": [
    m for m in sys.modules if m.startswith(("equss_tpu_torch.models", "equss_tpu_torch.train"))]}))
"""


def phase_export(results: dict, root: str, ckpt: str) -> None:
    """The export job through ``cli.main`` from the run's checkpoint at
    320^2, batch 8: pinned (``symbolic_batch=off``) and symbolic.  Each
    artifact's graph calls ``equss::attention_qkv`` 12 times and
    ``equss::pq_assign`` once; loaded with ``load_predictor``, it predicts
    as the live predictor of the same checkpoint on 8 val images (>= 99.99%
    of pixels equal; the symbolic one also at b = 1), 12 + 1 launches per
    request; the symbolic artifact also in a process that imports nothing
    of the model.  Then ms per b = 8 request, artifact and live in turns,
    and two requests of each profiled."""
    from equss_tpu_torch import launch_counts, reset_launch_counts, serve
    from equss_tpu_torch.cli import main as cli_main
    from equss_tpu_torch.core.checkpoint import CheckpointManager
    from equss_tpu_torch.data.pipeline import build_data
    from equss_tpu_torch.train.trainer import Trainer

    cfg = corpus_config(root)
    trainer = Trainer(cfg, device="cuda")
    trainer.load_train_state(CheckpointManager(ckpt).restore(), resume_training=False)
    live = serve.build_predict_fn(trainer)
    val = next(build_data(cfg, "val").batches(8, shuffle=False, drop_last=False))["img"]
    requests_launches = {k: 0 for k in launch_counts()}
    rows = {}
    for name, symbolic in (("pinned", "off"), ("symbolic", "auto")):
        path = os.path.join(root, f"{name}.pt2")
        t0 = time.perf_counter()
        cli_main(["export", *corpus_args(root), f"resume.checkpoint={ckpt}", "export.res=320",
                  "export.batch_size=8", f"export.symbolic_batch={symbolic}",
                  f"export.path={path}"])
        export_s = time.perf_counter() - t0
        graph = torch.export.load(path).graph
        targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
        ops = {op: targets.count(f"equss.{op}.default") for op in ("attention_qkv", "pq_assign")}
        batch_dim = [n for n in graph.nodes if n.op == "placeholder"][-1].meta["val"].shape[0]
        is_symbolic = not isinstance(batch_dim, int)
        check(ops == {"attention_qkv": 12, "pq_assign": 1} and is_symbolic == (name == "symbolic"),
              f"export {name}: ops {ops}, batch {batch_dim}")
        predict = serve.load_predictor(path)
        agreement = {}
        for b in ((1, 8) if is_symbolic else (8,)):
            x = val[:b]
            reset_launch_counts()
            out = predict(x)
            torch.cuda.synchronize()
            counts = launch_counts()
            requests_launches = {k: v + counts[k] for k, v in requests_launches.items()}
            reset_launch_counts()
            ref = live(torch.from_numpy(x).cuda())
            live_counts = launch_counts()
            agreement[b] = {k: (out[k] == ref[k]).float().mean().item() for k in ref}
            check(counts == live_counts == expected(SERVE_KERNELS, 1)
                  and set(out) == set(ref) == {"cluster_preds", "linear_preds"}
                  and all(out[k].dtype == torch.int32 and tuple(out[k].shape) == (b, 320, 320)
                          for k in out)
                  and all(v >= 0.9999 for v in agreement[b].values()),
                  f"export {name} b={b}: launches {counts} (live {live_counts}), "
                  f"agreement {agreement[b]}")
        rows[name] = {"export_seconds": export_s, "bytes": os.path.getsize(path),
                      "graph_ops": ops, "batch_dim": str(batch_dim),
                      "pixel_agreement_vs_live": agreement}
    results["launches"]["export_requests"] = requests_launches

    torch.save(torch.from_numpy(val), os.path.join(root, "val.pt"))
    proc = subprocess.run([sys.executable, "-c", _LOAD_ONLY, os.path.join(root, "symbolic.pt2"),
                           os.path.join(root, "val.pt"), os.path.join(root, "out.pt")],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    loaded_alone = {"rc": proc.returncode, "stderr": proc.stderr[-600:]}
    if proc.returncode == 0:
        loaded_alone = json.loads(proc.stdout.strip().splitlines()[-1])
        alone = torch.load(os.path.join(root, "out.pt"))
        ref = live(torch.from_numpy(val).cuda())
        loaded_alone["equal_to_live"] = all(torch.equal(alone[k], ref[k].cpu()) for k in ref)
    check(loaded_alone.get("equal_to_live") is True and loaded_alone["model_modules"] == []
          and loaded_alone["launches"] == expected(SERVE_KERNELS, 1),
          f"export: the artifact alone in a process without the model: {loaded_alone}")

    xf = torch.from_numpy(val).cuda().float() / 255.0
    artifact = serve.load_predictor(os.path.join(root, "symbolic.pt2"))
    turns = in_turns({"artifact": lambda: artifact(xf), "live": lambda: live(xf)}, iters=10)
    profiles = {}
    for name, fn in (("artifact", lambda: artifact(xf)), ("live", lambda: live(xf))):
        prof = device_profile(fn, 2)
        profiles[name] = {k: prof[k] for k in ("wall_ms", "device_ms", "device_busy_share",
                                                "kernel_launches")}
    emit({"phase": "export", "res": 320, **rows, "loaded_without_model": loaded_alone,
          "request_launches": requests_launches,
          "ms_per_b8_request": turns, "artifact_over_live": turns["artifact"] / turns["live"],
          "profile_two_b8_requests": profiles})


def phase_own_data(results: dict) -> None:
    """crop -> knn -> pack -> train on the files -> export, on a corpus
    written into a temporary directory, removed at the end."""
    root = tempfile.mkdtemp(prefix="equss_corpus_")
    try:
        phase_crop(root)
        phase_knn(results, root)
        phase_pack(root)
        ckpt = phase_train_files(results, root)
        phase_export(results, root, ckpt)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_custom_op_ab(results: dict) -> None:
    """Request latency of the serving forward (224^2, seeded weights) at
    b = 1 and b = 8 with the kernels called as the custom ops ``equss::``
    against the same kernels called through plain ctypes wrappers
    (``tools/ctypes_ab.py``, the wrappers before the custom ops), in turns
    (custom, ctypes, ctypes, custom; 3 rounds of 20 requests after 3
    warm-up ones): host clock to the synchronised result; medians.  Both
    give bit-equal outputs; each side's launches counted.  Then one
    request of each side profiled (device ms, busy share, kernels) and
    the host µs of one call of each wrapper, custom op and ctypes, at the
    b = 1 request's attention and PQ shapes (200 calls back to back, in
    turns)."""
    import contextlib
    import statistics

    from equss_tpu_torch import EQUSS, launch_counts, reset_launch_counts
    from equss_tpu_torch.core import trace
    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.ops.attention import attention_qkv
    from equss_tpu_torch.ops.pq_assign import normalize_vectors, pq_assign
    from equss_tpu_torch.tools import ctypes_ab

    model = EQUSS(main_config("bf16"), device="cuda", seed=0)
    ctypes_names = ("launch.attention_qkv_ctypes", "launch.pq_assign_ctypes")
    reset_launch_counts()
    row = {"phase": "custom_op_ab", "res": 224, "requests_per_turn": 20, "rounds": 3}
    for batch in (1, 8):
        img = normalize_images(requests(batch, 1, seed=900 + batch)[0].cuda())

        def timed(n):
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                out = model(img)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return times, out

        times, outs = {"custom_op": [], "ctypes": []}, {}
        for _ in range(3):
            for name in ("custom_op", "ctypes", "ctypes", "custom_op"):
                before_c = launch_counts()
                before_t = [trace.counts().get(k, 0) for k in ctypes_names]
                if name == "ctypes":
                    with ctypes_ab.ctypes_wrappers():
                        timed(3)
                        t, outs[name] = timed(20)
                else:
                    timed(3)
                    t, outs[name] = timed(20)
                times[name] += t
                made_c = {k: v - before_c[k] for k, v in launch_counts().items()}
                made_t = [trace.counts().get(k, 0) - b for k, b in zip(ctypes_names, before_t)]
                want = [12 * 23, 23] if name == "ctypes" else [0, 0]
                check(made_t == want and made_c == expected(
                          SERVE_KERNELS, 0 if name == "ctypes" else 23),
                      f"custom_op_ab {name} b={batch}: custom-op launches {made_c}, "
                      f"ctypes launches {made_t}")
        same = all(torch.equal(outs["custom_op"][k], outs["ctypes"][k]) for k in ("indices", "z_q"))
        check(same, f"custom_op_ab b={batch}: outputs differ between the two wrappers")
        med = {k: 1e3 * statistics.median(v) for k, v in times.items()}
        row[f"b{batch}"] = {"custom_op_ms_median": med["custom_op"], "ctypes_ms_median": med["ctypes"],
                            "difference_ms": med["custom_op"] - med["ctypes"],
                            "relative": med["custom_op"] / med["ctypes"] - 1.0,
                            "custom_op_ms_min": 1e3 * min(times["custom_op"]),
                            "ctypes_ms_min": 1e3 * min(times["ctypes"]), "outputs_equal": same}
    results["launches"]["custom_op_ab"] = launch_counts()

    # where the difference goes: one request of each side profiled, and
    # the host cost of one call of each wrapper at the b = 1 request's
    # shapes (kernels of a few µs, so back-to-back calls wait on the host)
    for batch in (1, 8):
        img = normalize_images(requests(batch, 1, seed=900 + batch)[0].cuda())
        for name in ("custom_op", "ctypes"):
            with ctypes_ab.ctypes_wrappers() if name == "ctypes" else contextlib.nullcontext():
                prof = device_profile(lambda: model(img), 2)
            row[f"b{batch}"][f"{name}_profile"] = {
                k: prof[k] for k in ("wall_ms", "device_ms", "device_busy_share", "kernel_launches")}
    g = torch.Generator(device="cuda").manual_seed(9)
    qkv = torch.randn((1, 785, 1152), generator=g, device="cuda").to(torch.bfloat16)
    z = torch.randn((28 * 28, 64, 16), generator=g, device="cuda")
    cb = torch.randn((64, 256, 16), generator=g, device="cuda")
    cn = normalize_vectors(cb, "l2").contiguous()
    calls = {
        "attention_qkv": {"custom_op": lambda: attention_qkv(qkv, 6, 0.125),
                          "ctypes": lambda: ctypes_ab.attention_qkv_ctypes(qkv, 6, 0.125)},
        "pq_assign": {"custom_op": lambda: pq_assign(z, cn, cb, normalize="l2", exact=False),
                      "ctypes": lambda: ctypes_ab.pq_assign_ctypes(z, cn, cb, normalize="l2",
                                                                   exact=False)},
    }

    def us_per_call(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / n

    row["us_per_call_back_to_back"] = {}
    for op, fns in calls.items():
        us = {k: [] for k in fns}
        for _ in range(3):
            for name in ("custom_op", "ctypes", "ctypes", "custom_op"):
                us[name].append(us_per_call(fns[name]))
        row["us_per_call_back_to_back"][op] = {k: statistics.median(v) for k, v in us.items()}
    emit(row)


# the models/variants.py slices: (config, train batch, valid batch,
# attention launches per train step, the trainable gradients held by the
# reference step: name -> parameter-name prefix; cluster_swav's
# prototypes take no gradient while frozen, in its first 100 steps)
VARIANTS = (
    ("pqgo_cls_cocostuff27", 16, 8, 36, {"head": "head.", "classifier": "classifier."}),
    ("cluster_margin_cocostuff27", 16, 8, 12, {"net": "net."}),
    ("cluster_swav_cocostuff27", 64, 32, 12, {"net": "net."}),
    ("res_cocostuff27", 16, 8, 12, {"semantic": "semantic.", "local": "local.",
                                    "agg": "agg.", "dec": "dec."}),
    ("unseg_cocostuff27", 16, 8, 12, {"enc": "net.enc.", "dec": "net.dec.", "pq": "pq."}),
    ("new_vq_cocostuff27", 16, 8, 12, {"enc": "net.enc.", "dec": "net.dec.", "pq": "pq."}),
    ("spq_cocostuff27", 16, 8, 12, {"enc": "enc.", "codebook": "codebook"}),
    ("vae_cocostuff27", 16, 8, 12, {"enc": "net.enc_", "dec": "net.dec_", "pq": "pq."}),
    ("info_cocostuff27", 128, 32, 12, {"enc": "net.enc.", "vq_in": "net.vq_in_",
                                       "dec": "net.dec."}),
    ("contra_cocostuff27", 64, 32, 12, {"enc": "net.enc.", "vq_in": "net.vq_in_",
                                        "dec": "net.dec."}),
    ("ema_cocostuff27", 16, 8, 24, {"head": "head.", "centroid": "centroid"}),
)
# the variants whose valid step launches the PQ kernel: config prefix ->
# (launches per valid step, the wide body's launches in order or None for
# the narrow fast body (pqgocls): ((M, K, d), exact, rows per 320^2 image))
PQ_VALID = {"pqgo_cls": (1, None), "unseg": (1, [((1, 2048, 384), True, 1600)]),
            "new_vq": (1, [((8, 2048, 64), False, 1600)]),
            "vae": (2, [((1, 1024, 256), True, 400), ((1, 1024, 256), True, 1600)]),
            "contra": (2, [((4, 1024, 128), True, 1600), ((16, 1024, 32), True, 1600)])}


def pq_valid(name: str):
    """(launches per valid step, the wide body's launches or None)."""
    key = next((k for k in PQ_VALID if name.startswith(k)), None)
    return (0, None) if key is None else PQ_VALID[key]


def without_view(batches: list) -> list:
    """The synthetic batches without their ``aug_img``, so that the
    trainer draws the photometric view on the card."""
    return [{k: v for k, v in b.items() if k != "aug_img"} for b in batches]


def phase_variants(results: dict) -> None:
    """The configs of the variants slices at their widths and batches
    (``VARIANTS``): 4 train steps after 2 warm-up with the view drawn on
    the card, ``validate`` over 2 batches of 320^2 after 2, the per-step
    checks of each family, and profiles of 2 train and 2 valid steps
    (device ms and busy share; UnSeg's and NewVQ's valid profiles with the
    wide PQ body's ms per launch and share of bound in path)."""
    from equss_tpu_torch.data.synthetic import synthetic_batches

    for i, (name, bs, vbs, attn, _) in enumerate(VARIANTS):
        cfg, tr = preset_trainer(name)
        m = tr.model
        torch.cuda.reset_peak_memory_stats()
        batches = without_view(list(synthetic_batches(20 + i, 6, bs, res=224,
                                                      num_classes=27)))
        init_row = {}
        if getattr(m, "needs_data_init", False):
            # the first batch's data-dependent init, as a fresh fit runs it
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.data_init(batches[0])
            torch.cuda.synchronize()
            init_row = {"data_init_s": time.perf_counter() - t0,
                        "data_init_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
            torch.cuda.reset_peak_memory_stats()
        if name.startswith("ema"):
            check(int(m.bank_initialized) == 1 and bool((m.queue != 0).any()),
                  f"{name}: data_init left the memory bank empty")
        before = {k: v.clone() for k, v in m.state_dict().items()
                  if not k.startswith("backbone.")}
        metrics, timing = timed_train(tr, batches, 2, {"attention_qkv": attn},
                                      f"{name}_train", results)
        row = {"phase": "variants", "config": name, "what": "train", "batch": bs, **timing,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, **init_row,
               **{f"{k}_per_step": [x[k] for x in metrics]
                  for k in LOSS_TERMS + ("club-enc-loss-first", "grad-norm", "vq0-usage",
                                         "vq1-usage") if k in metrics[0]}}
        if name.startswith("cluster_swav"):
            row["swav_it"], row["swav_queue_n"] = int(m.swav_it), int(m.swav_queue_n)
            check(row["swav_it"] == 6 and 0 < row["swav_queue_n"] <= m.queue_len
                  and not torch.equal(m.swav_queue, before["swav_queue"]),
                  f"{name}: SwAV state did not advance {row}")
        if name.startswith("res"):
            check(all(x["club-enc-loss"] < x["club-enc-loss-first"] for x in metrics),
                  f"{name}: the CLUB inner loop did not lower its NLL")
            check(not torch.equal(m.dec.dec_0.norm1.mean, before["dec.dec_0.norm1.mean"])
                  and int(m.club_opt.count) == 6 * m.mi_iter, f"{name}: state did not move")
        if name.startswith("pqgo_cls"):
            # one more step: the EMA head nearer the student it averages in
            student = {k: v.detach().clone() for k, v in m.head.named_parameters()}
            ema_old = {k: v.clone() for k, v in m.ema_head.named_buffers()}
            tr.train_step(batches[-1])
            gap = lambda ema: math.sqrt(sum(float(((ema[k] - student[k]) ** 2).sum())  # noqa
                                            for k in student))
            row["ema_gap_before_after"] = [gap(ema_old), gap(dict(m.ema_head.named_buffers()))]
            check(0 < row["ema_gap_before_after"][1] < row["ema_gap_before_after"][0],
                  f"{name}: the EMA head did not move toward the student {row}")
        if name.startswith("unseg"):
            check(not torch.equal(m.net.dec.dec_0.norm1.mean,
                                  before["net.dec.dec_0.norm1.mean"])
                  and bool((m.pq_state[0].vq_count > 0).any()),
                  f"{name}: the decoder's BatchNorm or the quantizer's counts did not move")
        if name.startswith("new_vq"):
            check(all(np.isfinite(x["info_nce-loss"]) and x["info_nce-loss"] > 0
                      for x in metrics), f"{name}: info_nce-loss not finite and positive")
        if name.startswith("spq"):
            row["codebook_max_change"] = (m.codebook - before["codebook"]).abs().max().item()
            check(all(x["jsd"] >= 0 for x in metrics) and row["codebook_max_change"] > 0,
                  f"{name}: jsd negative or the codebook did not move {row}")
        if name.startswith("vae"):
            check(all(x["contra-loss-pos"] >= 0 for x in metrics),
                  f"{name}: contra-loss-pos negative")
        if name.startswith("info"):
            check(all(np.isfinite(x[k]) for x in metrics for k in ("vq0-usage", "vq1-usage")),
                  f"{name}: vq0-usage or vq1-usage not finite")
        if name.startswith("ema"):
            check(not torch.equal(m.queue, before["queue"])
                  and not torch.equal(m.ema_head.cluster1.weight,
                                      before["ema_head.cluster1.weight"])
                  and int(m.bank_initialized) == 1,
                  f"{name}: the queue or the EMA head did not move")
        if name.startswith("contra"):
            row["moved_params_ema_per_step"] = micro_steps_move(tr, batches[:2])
            check(row["moved_params_ema_per_step"] == [[False, True], [True, True]],
                  f"{name}: parameters must move on every second step, the EMA codebooks "
                  f"on every step {row['moved_params_ema_per_step']}")
        emit(row)
        vb = valid_batches(4, vbs, seed=360 + i)
        pq_launches, wide = pq_valid(name)
        per_valid = {"attention_qkv": 12, "pq_assign": pq_launches}
        val, res, vtiming = timed_validate(tr, vb, 2, per_valid, f"{name}_valid", results)
        check(tuple(res["linear_preds"].shape) == (vbs, 320, 320), f"{name} valid: shapes")
        emit({"phase": "variants", "config": name, "what": "valid", "batch": vbs, "res": 320,
              **vtiming, **val})
        cycle = iter(batches * 2)
        emit({"phase": "profile", "what": f"{name}_train", "batch": bs, "steps": 2,
              **device_profile(lambda: tr.train_step(next(cycle)), 2, pick=KERNEL_PICK)})
        vcycle = iter(vb * 2)
        prof = device_profile(lambda: tr.valid_step(next(vcycle)), 2, pick=KERNEL_PICK,
                              sequence=None if wide is None else "pq_wide")
        if wide is not None:
            prof.update(wide_launches_in_path(prof, wide, vbs, f"{name} valid",
                                              results["pq_wide_isolated"]))
        emit({"phase": "profile", "what": f"{name}_valid", "batch": vbs, "res": 320,
              "steps": 2, **prof})
        del tr, m
        torch.cuda.empty_cache()


def micro_steps_move(tr, batches: list) -> list:
    """Under ``train.num_accum`` 2 from the start of an update: for each
    train step on ``batches``, whether any trainable parameter and whether
    the first quantizer's EMA codebook moved."""
    m = tr.model
    check(tr.tx_model.mini_step == 0, "micro-step check: not at the start of an update")
    moved = []
    for b in batches:
        params = {k: p.detach().clone() for k, p in tr.model_params}
        ema = m.pq_state[0].ema_weight.clone()
        tr.train_step(b)
        moved.append([any(not torch.equal(p, params[k]) for k, p in tr.model_params),
                      not torch.equal(m.pq_state[0].ema_weight, ema)])
    return moved


def stage1_config(n_kmeans: int) -> dict:
    """``new_vq_cocostuff27`` with ``model.stage: 1``: ``eval.output_type:
    feat`` (stage 1 has no spatial z_q) and no InfoNCE weight (stage 1
    computes none; the trainer, as JAX's, raises on a weighted term a
    model does not emit)."""
    return with_overrides(preset("new_vq_cocostuff27"), {
        "model.stage": 1, "model.n_kmeans": n_kmeans, "eval.output_type": "feat",
        "loss.info_nce_weight": 0.0})


def phase_new_vq_stage1(results: dict) -> None:
    """NewVQ's stage 1 at b = 16 + the view: 2 train steps after 1, the
    step median, the k-means share of each step (the call timed between
    two synchronisations), peak memory, 12 attention launches and no PQ
    launch per step (training takes the plain route), every metric
    finite."""
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.models import variants
    from equss_tpu_torch.train.trainer import Trainer

    tr = Trainer(stage1_config(100), device="cuda", seed=0)
    kmeans_s = []
    plain_kmeans = variants.kmeans

    def timed_kmeans(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_kmeans(*args, **kw)
        torch.cuda.synchronize()
        kmeans_s.append(time.perf_counter() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    batches = without_view(list(synthetic_batches(30, 3, 16, res=224, num_classes=27)))
    variants.kmeans = timed_kmeans
    try:
        metrics, timing = timed_train(tr, batches, 1, STOCK_TRAIN_KERNELS,
                                      "new_vq_stage1_train", results)
    finally:
        variants.kmeans = plain_kmeans
    median_s = timing["ms_per_step_median"] / 1e3
    emit({"phase": "stage1", "config": "new_vq_cocostuff27", "stage": 1, "n_kmeans": 100,
          "batch": 16, "rows_selected": 2048 * 100, **timing,
          "kmeans_ms_per_step": [1e3 * k for k in kmeans_s[1:]],
          "kmeans_share_of_median_step": [k / median_s for k in kmeans_s[1:]],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          **{f"{k}_per_step": [x[k] for x in metrics]
             for k in ("loss", "vq-loss", "recon-loss", "codebook-usage") if k in metrics[0]}})
    del tr
    torch.cuda.empty_cache()


def variant_draws(name: str, batch: dict, rs) -> dict:
    """``batch`` (b = 2 at 224^2, with its view) with a variant's random
    draws fixed from ``rs``: the InfoNCE negatives, Info's Gumbel noise,
    Contra's split noise, EMAModel's dropout keep masks and proxy
    indices."""
    n = 2 * 28 * 28
    batch["info_nce_idx"] = rs.randint(0, n, (n, 10))
    if name.startswith("info"):
        for i in range(2):
            u = rs.uniform(np.finfo(np.float32).tiny, 1.0, (n, 1, 1024))
            batch[f"gumbel_{i}"] = (-np.log(-np.log(u))).astype(np.float32)
    if name.startswith("contra"):
        for i, m in enumerate((4, 16)):
            batch[f"split_noise_{i}"] = rs.randn(m, 1024, 512 // m).astype(np.float32)
    if name.startswith("ema"):
        batch["dropout_keep"] = rs.uniform(size=(2, 2, 1, 1, 384)) < 0.9
        batch["proxy_q_idx"] = rs.randint(0, 64, (27, 16))
        batch["proxy_neg_idx"] = rs.randint(0, 26 * 64, (27, 16 * 64))
    return batch


def kmeans_draws(rs, levels) -> dict:
    """k-means++ draws for ``data_init`` (``levels``: (M, rows, k) per
    quantizer or bank): the first row and the Gumbel noise of each."""
    draws = {}
    for i, (M, rows, k) in enumerate(levels):
        draws[f"kmeans_first_{i}"] = torch.from_numpy(rs.randint(0, rows, (M,)))
        u = rs.uniform(np.finfo(np.float32).tiny, 1.0, (k - 1, M, rows))
        draws[f"kmeans_gumbel_{i}"] = torch.from_numpy((-np.log(-np.log(u))).astype(np.float32))
    return draws


def data_init_reference(name: str, batch: dict, levels) -> dict:
    """``data_init`` of ``preset(name)`` on the card and on the CPU from
    the same seeded weights, batch and k-means draws, twice: on the CPU's
    backbone features fed to both (``same_features``: what the card's
    encoder, k-means and selection compute), and end to end, each on its
    own backbone features (``end_to_end``: printed, not held; the bf16
    backbone's ~1e-2 feature error, which k-means spreads to every
    centroid).  For each tensor it sets: the share of rows (codewords,
    centroids, queue entries; each cluster's queue as a set of rows, whose
    order follows near-equal distances) within 1e-3 of the tensor's scale
    of the CPU's, held at >= 90% on the same features (a pixel whose two
    nearest centroids tie to rounding may join the other cluster on the
    other device, which moves both), and the relative error."""
    draws = kmeans_draws(np.random.RandomState(7), levels)
    trainers = {device: preset_trainer(name, device, False)[1] for device in ("cuda", "cpu")}
    imgs = {d: tr._batch(batch, keys=("img", "label"))["img"] for d, tr in trainers.items()}
    with torch.no_grad():
        feat = trainers["cpu"].model.features(imgs["cpu"])
        new = {"cpu": trainers["cpu"].model.data_init(imgs["cpu"], None, **draws),
               "end_to_end": trainers["cuda"].model.data_init(imgs["cuda"], None, **draws)}
        card = trainers["cuda"].model
        card.features = lambda img: feat.to(card.device)
        new["same_features"] = card.data_init(imgs["cuda"], None, **draws)
        del card.features
    row = {}
    for how in ("same_features", "end_to_end"):
        row[how] = {}
        for k, want in new["cpu"].items():
            got, want = new[how][k].float().cpu(), want.float()
            if k == "queue":
                got, want = got.sort(1).values, want.sort(1).values
            scale = want.abs().max().item()
            rows = (got - want).abs().reshape(-1, want.shape[-1] if want.ndim else 1).amax(-1)
            row[how][k] = {"rows_within_1e-3_of_scale":
                           (rows <= 1e-3 * scale).float().mean().item(),
                           "rel_err": ((got - want).norm() / want.norm()).item()}
            if how == "same_features":
                check(row[how][k]["rows_within_1e-3_of_scale"] >= 0.9,
                      f"{name} data_init reference on the CPU's features: {k} {row[how][k]}")
    return row


def phase_variants_reference() -> None:
    """One train step of each variant config at b = 2, dropout off (on for
    EMAModel, its keep masks fixed), card against CPU
    (``reference_step``), the view (the CPU's photometric view of the
    batch), InfoNCE negatives, STEGO samples, the Gumbel and split noise
    and the proxy indices fixed in the batch; then NewVQ at a codebook of
    2 048 of the CPU's own codes per subspace, NewVQ's stage 1 (at
    ``n_kmeans`` 10: 20 480 selected rows, which the CPU quantizes in
    seconds) with its k-means draws fixed in the batch too, and the
    ``data_init`` of Contra and EMAModel given the same k-means draws."""
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.data.transforms import photometric_aug
    from equss_tpu_torch.train.trainer import Trainer

    runs = [(name, grads, lambda device, name=name: preset_trainer(
        name, device, name.startswith("ema"))[1]) for name, _, _, _, grads in VARIANTS]
    new_vq_grads = next(g for n, *_, g in VARIANTS if n == "new_vq_cocostuff27")
    runs.append(("new_vq_cocostuff27_stage1", new_vq_grads,
                 lambda device: Trainer(stage1_config(10), device=device, seed=0)))
    for i, (name, grads, make_trainer) in enumerate(runs):
        batch = stego_samples(next(synthetic_batches(40 + i, 1, 2, res=224,
                                                     num_classes=27)), 40 + i)
        img01 = torch.from_numpy(batch["img"]).clamp(0, 1)
        batch["aug_img"] = photometric_aug(torch.Generator().manual_seed(i), img01).numpy()
        n = 2 * 28 * 28
        rs = np.random.RandomState(i)
        variant_draws(name, batch, rs)
        if name.endswith("stage1"):     # k-means over both views' pixels, k = 2048
            batch["kmeans_first"] = rs.randint(0, 2 * n, (1,))
            u = rs.uniform(np.finfo(np.float32).tiny, 1.0, (2047, 1, 2 * n))
            batch["kmeans_gumbel"] = (-np.log(-np.log(u))).astype(np.float32)
        # NewVQ's indices are of its code, bf16 at the initial codebook:
        # the quantizer on the card's code, and end to end on the pairs
        # whose CPU minimum is untied (as for the VQ baseline)
        own = name == "new_vq_cocostuff27"
        row = reference_step(make_trainer, batch, grads, f"{name} train reference",
                             e2e_bar=not own, quantizer=own,
                             indices=not name.endswith("stage1"))
        emit({"phase": "variants_reference", "config": name, **row})
        if own:
            new_vq_data_codebook_reference(make_trainer, batch, grads)
        if name.startswith("contra"):
            # k-means at K = 1024 over each subspace's 1 568 pixels
            emit({"phase": "variants_reference", "config": name, "what": "data_init",
                  **data_init_reference(name, batch, [(4, n, 1024), (16, n, 1024)])})
        if name.startswith("ema"):
            emit({"phase": "variants_reference", "config": name, "what": "data_init",
                  **data_init_reference(name, batch, [(1, n, 27)])})


def new_vq_data_codebook_reference(make_trainer, batch: dict, grads: dict) -> None:
    """NewVQ's train reference at a codebook of 2 048 of the CPU's own
    codes per subspace (8 x 2048 x 64, a data initialisation), copied into
    both trainers' ``pq.codebook``: there the minima are mostly untied, so
    the end-to-end bar (>= 95% on the untied pairs) holds most pairs;
    ``cpu_untied_share`` says how many.  The loss terms and the encoder's
    and decoder's gradients are held as in every reference row.  The
    codebook's gradient is the scatter of one term per (pixel, subspace)
    pair onto the codeword each device assigns it (``codebook_gradient_
    terms``): the terms must sum to autograd's gradient on each device
    (cosine >= 0.9999), and over the pairs that both devices assign to the
    same codeword the two gradients' cosine is held >= 0.98.  Printed
    beside it, unheld: the norms and cosines over all pairs, over those
    whose pixel was picked as a codeword and over the others, and the
    share of the others' squared terms on pairs the devices assign
    differently (a term on another codeword shares nothing with its
    counterpart, so the others' cosine falls by about that share)."""
    tr0 = make_trainer("cpu")
    b = tr0._batch(batch, aug=True)
    with torch.no_grad():           # the codes of both views: 3 136 pixels
        code = tr0.model(torch.cat([b["img"], b["aug_img"]]), training=False)["code"]
    code = code.reshape(-1, 8, 64)
    g = torch.Generator().manual_seed(9)
    pick = torch.stack([torch.randperm(code.shape[0], generator=g)[:2048] for _ in range(8)])
    data_cb = torch.stack([code[pick[m], m] for m in range(8)]).contiguous()   # (8, 2048, 64)
    picked = torch.zeros(code.shape[:2], dtype=torch.bool)
    picked[pick, torch.arange(8)[:, None]] = True
    del tr0, code
    seen = {}

    def data_trainer(device):
        tr = make_trainer(device)
        with torch.no_grad():
            tr.model.pq["codebook"].copy_(data_cb)
        # the encoder's output over both views: the quantizer's input
        tr.model.net.enc.register_forward_hook(
            lambda mod, args, out: seen.__setitem__(device, (tr, out.detach())))
        return tr

    what = "new_vq_cocostuff27 train reference, data codebook"
    held = {k: v for k, v in grads.items() if k != "pq"}
    row = reference_step(data_trainer, batch, held, what, e2e_bar=False,
                         reported={"pq": grads["pq"]})
    check(row["untied_pairs"] > 0, f"{what}: no untied pair")
    runs = {dev: codebook_gradient_terms(*seen[dev]) for dev in ("cuda", "cpu")}
    same = runs["cuda"]["idx"] == runs["cpu"]["idx"]
    masks = {"all": torch.ones_like(same), "picked": picked, "other": ~picked,
             "same_index": same, "other_same_index": ~picked & same}
    parts = {dev: {k: r["scatter"](mask) for k, mask in masks.items()}
             for dev, r in runs.items()}
    cos = lambda a, b: torch.nn.functional.cosine_similarity(  # noqa: E731
        a.flatten(), b.flatten(), dim=0).item()
    sq = (runs["cpu"]["terms"] ** 2).sum(-1)
    split = {**{f"{k}_pairs": int(mask.sum()) for k, mask in masks.items()},
             **{f"{k}_norm_{dev}": parts[dev][k].norm().item()
                for k in masks for dev in runs},
             **{f"{k}_cosine": cos(parts["cuda"][k], parts["cpu"][k]) for k in masks},
             **{f"terms_over_autograd_cosine_{dev}": cos(parts[dev]["all"], r["autograd"])
                for dev, r in runs.items()},
             "other_squared_terms_share_on_differing_pairs":
                 (sq[~picked & ~same].sum() / sq[~picked].sum()).item()}
    check(all(split[f"terms_over_autograd_cosine_{dev}"] >= 0.9999 for dev in runs),
          f"{what}: the codebook gradient is not the sum of its pairs' terms {split}")
    check(split["same_index_cosine"] >= 0.98,
          f"{what}: codebook gradient cosine over the pairs of the same index "
          f"{split['same_index_cosine']}")
    emit({"phase": "variants_reference", "config": "new_vq_cocostuff27", "codebook": "data",
          "untied_pairs_are_most": row["cpu_untied_share"] > 0.5, **row,
          "codebook_gradient": split})


def codebook_gradient_terms(tr, z: torch.Tensor) -> dict:
    """The codebook gradient of a trainer ``tr`` whose backward has run,
    and its terms from ``vq-loss`` (``book`` * mean((z_q - z)^2), the
    codebook's only term at ``jsd_weight`` 0) on the quantizer input ``z``
    (pixels, M * d): ``autograd`` (the parameter's ``.grad``, (M, K, d)),
    ``terms`` 2 * book * (z_q - z) / z.numel() (pixels, M, d), the
    quantizer's ``idx`` (pixels, M) and ``scatter(mask)``, the sum of the
    terms of the pairs ``mask`` (pixels, M) onto their codewords; all on
    the CPU."""
    from equss_tpu_torch.ops.quantizer import pq_forward

    m = tr.model
    cfg = model_pq_cfg(m)
    codebook = m.pq["codebook"].detach()
    with torch.no_grad():
        _, idx, _, _ = pq_forward(z, {"codebook": codebook}, m.pq_state.as_dict(), cfg,
                                  training=True)
    zf = z.reshape(-1, cfg.num_pq, cfg.sub_dim).float()
    idx = idx.reshape(zf.shape[:2]).long()
    src = codebook.float() if cfg.assign_precision == "exact" else \
        codebook.to(torch.bfloat16).float()
    sub = torch.arange(cfg.num_pq, device=z.device).expand_as(idx)
    terms = ((src[sub, idx] - zf) * (2.0 * cfg.book / zf.numel())).cpu()
    flat = (sub * cfg.num_codebook + idx).reshape(-1).cpu()

    def scatter(mask: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(cfg.num_pq * cfg.num_codebook, cfg.sub_dim)
        out.index_add_(0, flat, terms.reshape(-1, cfg.sub_dim) * mask.reshape(-1, 1).float())
        return out.reshape(codebook.shape)

    return {"autograd": m.pq["codebook"].grad.detach().float().cpu(), "terms": terms,
            "idx": idx.cpu(), "scatter": scatter}


DIST_STEPS = 3
DIST_NCCL1_WARM, DIST_NCCL1_TIMED = 2, 8
DIST_BATCH = 16
DIST_TIMEOUT_S = 300


def dist_free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dist_state(tr) -> torch.Tensor:
    """A trainer's weights (model and probes), optimizer moments and model
    state as one flat f32 vector on the host."""
    parts = [t.detach().float().reshape(-1) for t in tr.state_dict().values()]
    for tx in (tr.tx_model, tr.tx_cluster, tr.tx_linear):
        for v in tx.state_dict()["state"].values():
            parts += [t.float().reshape(-1) for t in (v.values() if isinstance(v, dict) else [v])
                      if torch.is_tensor(t)]
    return torch.cat([t.cpu() for t in parts])


def dist_grads(tr) -> dict:
    """The head's and the codebook's gradients after ``forward_backward``."""
    return {n: p.grad.detach().cpu().clone() for n, p in tr.model_params
            if n.startswith(("head.", "pq.codebook"))}


def dist_steps(tr, batches: list, ranks_equal: bool = False) -> dict:
    """Train steps, each timed on the host clock to its synchronised end,
    launches counted from 0; with ``ranks_equal`` whether every rank holds
    rank 0's state bit for bit after each step."""
    import torch.distributed as dist

    from equss_tpu_torch import launch_counts, reset_launch_counts

    reset_launch_counts()
    times, metrics, equal = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        metrics.append(tr.train_step(b))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if ranks_equal:
            mine = dist_state(tr)
            ref = mine.clone()
            dist.broadcast(ref, src=0)
            diff = torch.tensor([float(not torch.equal(mine, ref))])
            dist.all_reduce(diff)
            equal.append(diff.item() == 0.0)
    return {"metrics": metrics, "ms": [1e3 * t for t in times], "launches": launch_counts(),
            "ranks_equal": equal, "state": dist_state(tr)}


def dist_child_nccl1(out_path: str, port: int) -> None:
    """(a): the pqgo ``kernel`` step at b = 16 for 2 warm-up and 8 timed
    steps without a process group, then the same steps in a one-rank NCCL
    group (every collective of the distributed path runs), both with
    deterministic algorithms so that the two may be held bit for bit, and
    a profile of 2 more steps each way; and one all-reduce of the
    flattened gradient's size timed alone."""
    import torch.distributed as dist

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.allow_tf32 = False
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.parallel import mesh

    batches = list(synthetic_batches(0, DIST_NCCL1_WARM + DIST_NCCL1_TIMED, DIST_BATCH,
                                     res=224, num_classes=27))
    _, tr = train_model("kernel")
    alone = dist_steps(tr, batches)
    cycle = iter(batches * 2)
    profiles = {"alone": device_profile(lambda: tr.train_step(next(cycle)), 2,
                                        pick=("nccl", "Memcpy", "Memset"))}
    del tr
    # a group of one rank (init_distributed joins none for one process)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        _, tr = train_model("kernel")
        check(tr.distributed, "nccl1: the trainer does not see its group")
        grouped = dist_steps(tr, batches)
        cycle = iter(batches * 2)
        profiles["nccl1"] = device_profile(lambda: tr.train_step(next(cycle)), 2,
                                           pick=("nccl", "Memcpy", "Memset"))
        bucket = torch.zeros(sum(p.numel() for _, p in (*tr.model_params, *tr.probe_params)),
                             device="cuda")
        with mesh.global_program():
            bucket_ms = cuda_ms(lambda: mesh.all_reduce_sum(bucket), 20)
    finally:
        dist.destroy_process_group()
    torch.save({"alone": alone, "grouped": grouped, "bucket_ms": bucket_ms,
                "bucket_numel": bucket.numel(), "profiles": profiles}, out_path)
    if FAILURES:
        raise RuntimeError(f"nccl1: {FAILURES}")


def dist_child_ranks(rank: int, world: int, backend: str, port: int, out_dir: str) -> None:
    """(b) and (c) on one rank of ``world``: the pqgo ``kernel`` step's
    first-step gradients and 3 steps at the global b = 16, then one vq
    step at the global b = 16, each rank on its rows of the same global
    batches."""
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.parallel import mesh

    mesh.init_distributed(f"localhost:{port}", world, rank, device="cuda", backend=backend)
    try:
        check(mesh.world() == world and mesh.rank() == rank, "ranks: the group")
        batches = list(synthetic_batches(0, DIST_STEPS, DIST_BATCH, res=224, num_classes=27,
                                         process_index=rank, process_count=world))
        dev = mesh.local_device("cuda")
        _, tr = train_model("kernel", device=str(dev))
        tr.forward_backward(batches[0])
        grads = dist_grads(tr)
        _, tr = train_model("kernel", device=str(dev))
        steps = dist_steps(tr, batches, ranks_equal=True)
        del tr
        cfg = preset("vq_cocostuff27")
        from equss_tpu_torch.train.trainer import Trainer

        vq = Trainer(cfg, device=str(dev), seed=0)
        vq_m = vq.train_step(batches[0])
        counts = {k: vq.model.pq_state.as_dict()[k].cpu() for k in ("vq_count", "ema_count")}
        vq_equal = torch.equal(dist_state(vq), mesh.broadcast_object(dist_state(vq),
                                                                      is_source=rank == 0))
    finally:
        dist.destroy_process_group()
    torch.save({"grads": grads, "steps": steps, "vq_metrics": vq_m, "vq_counts": counts,
                "vq_ranks_equal": vq_equal, "device": str(dev)},
               os.path.join(out_dir, f"rank{rank}.pt"))
    if FAILURES:
        raise RuntimeError(f"rank {rank}: {FAILURES}")


def dist_spawn(ctx, targets: list, what: str, timeout_s: float = DIST_TIMEOUT_S) -> bool:
    """Start every (function, args) of ``targets`` as a process, wait up
    to ``timeout_s`` for all; a process that fails or hangs fails the
    phase, and every one is stopped."""
    procs = [ctx.Process(target=fn, args=args) for fn, args in targets]
    for p in procs:
        p.start()
    deadline = time.time() + timeout_s
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(30)
    codes = [p.exitcode for p in procs]
    return check(all(c == 0 for c in codes), f"distributed {what}: process exit codes {codes}")


# the variants across ranks: every config of ``VARIANTS`` at its widths,
# the global batch 4 (2 rows a rank), a first step and 2 more
DIST_VARIANT_BATCH = 4
DIST_VARIANT_STEPS = 3
DIST_VARIANT_TIMEOUT_S = 720
# the wide PQ paths whose valid step runs across the ranks (320^2)
DIST_VARIANT_VALID = ("unseg", "new_vq", "vae", "contra")
# the families with new state collectives: one NCCL rank against no group
DIST_VARIANT_NCCL1 = ("cluster_swav", "contra", "ema")
DIST_STAGE1_KMEANS = 100
DIST_LOSS_TERMS = LOSS_TERMS + ("jsd", "club-enc-loss-first")


def dist_rows(batch: dict) -> dict:
    """This process's rows of a global host batch (all of them without a
    group)."""
    from equss_tpu_torch.parallel import mesh

    n = DIST_VARIANT_BATCH // mesh.world()
    return {k: v[mesh.rank() * n:(mesh.rank() + 1) * n] for k, v in batch.items()}


def dist_ranks_equal(tr) -> bool:
    """Whether this rank's train state equals rank 0's bit for bit (True
    without a group)."""
    from equss_tpu_torch.parallel import mesh

    mine = dist_state(tr)
    return torch.equal(mine, mesh.broadcast_object(mine, is_source=mesh.rank() == 0))


def dist_variant_case(i: int, name: str, ranks_equal: bool, valid: bool = True) -> dict:
    """``VARIANTS[i]`` on this process's rows of the global batch of
    ``DIST_VARIANT_BATCH``: a valid step at 320^2 first for the wide PQ
    paths, the first batch's ``data_init`` where the model needs one, then
    ``DIST_VARIANT_STEPS`` steps with the view drawn on the card.  Returns
    the first batch's backbone features, the valid step's predictions and
    PQ indices, the metrics, the first step's gradients by parameter
    group, the launches of the steps, each step's ms (host clock to the
    synchronised end), the train state, and with ``ranks_equal`` whether
    every rank held rank 0's state after ``data_init`` and after each
    step."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.parallel import mesh

    groups = VARIANTS[i][4]
    cfg, tr = preset_trainer(name, device=str(mesh.local_device("cuda")))
    batches = [dist_rows(b) for b in without_view(list(synthetic_batches(
        40 + i, DIST_VARIANT_STEPS, DIST_VARIANT_BATCH, res=224, num_classes=27)))]
    out = {"equal": []}
    # the frozen backbone's features of the first batch's images, for the
    # comparison of a rank's rows with the one-process run's
    with torch.no_grad():
        out["features"] = tr.model.features(
            tr._batch(batches[0], keys=("img", "label"))["img"]).cpu()
    if valid and name.startswith(DIST_VARIANT_VALID):
        from equss_tpu_torch.ops import quantizer

        vb = dist_rows(valid_batches(1, DIST_VARIANT_BATCH, seed=460 + i)[0])
        # the PQ kernel's indices of each launch, as the quantizer gets them
        indices, plain = [], quantizer.pq_assign

        def recorded(*args, **kw):
            res = plain(*args, **kw)
            indices.append(res[0].cpu())
            return res

        torch.cuda.synchronize()
        reset_launch_counts()
        quantizer.pq_assign = recorded
        try:
            res = tr.valid_step(vb)
        finally:
            quantizer.pq_assign = plain
        torch.cuda.synchronize()
        out["valid"] = {"launches": launch_counts(), "pq_indices": indices,
                        **{k: res[k].cpu() for k in ("linear_preds", "cluster_preds")}}
    if getattr(tr.model, "needs_data_init", False):
        tr.data_init(batches[0])
        if ranks_equal:
            out["equal"].append(dist_ranks_equal(tr))
    torch.cuda.synchronize()
    reset_launch_counts()
    metrics, times = [], []
    for j, b in enumerate(batches):
        t0 = time.perf_counter()
        metrics.append(tr.train_step(b))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if j == 0:
            out["grads"] = {g: torch.cat([p.grad.detach().float().reshape(-1).cpu()
                                          for n, p in tr.model_params
                                          if n.startswith(prefix) and p.grad is not None])
                            for g, prefix in groups.items()}
        if ranks_equal:
            out["equal"].append(dist_ranks_equal(tr))
    out.update(launches=launch_counts(), metrics=metrics, ms=[1e3 * t for t in times],
               state=dist_state(tr))
    del tr
    torch.cuda.empty_cache()
    return out


def dist_stage1_case() -> dict:
    """NewVQ's stage 1 (``n_kmeans`` ``DIST_STAGE1_KMEANS``) for one step on
    this process's rows of a global batch of ``DIST_VARIANT_BATCH`` + the
    view: the rows it selected, the metrics and the launches."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.parallel import mesh
    from equss_tpu_torch.train.trainer import Trainer

    tr = Trainer(stage1_config(DIST_STAGE1_KMEANS), device=str(mesh.local_device("cuda")),
                 seed=0)
    batch = dist_rows(without_view(list(synthetic_batches(
        50, 1, DIST_VARIANT_BATCH, res=224, num_classes=27)))[0])
    from equss_tpu_torch.models import variants

    # the k-means' input rows and centroids, as the stage gives them
    seen, plain = {}, variants.kmeans

    def recorded(x, *args, **kw):
        res = plain(x, *args, **kw)
        seen.update(rows=x.cpu(), centroids=res[0].cpu())
        return res

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    variants.kmeans = recorded
    try:
        metrics, out = tr.forward_backward(batch)
    finally:
        variants.kmeans = plain
    torch.cuda.synchronize()
    row = {"ms": 1e3 * (time.perf_counter() - t0), "launches": launch_counts(),
           "selected": out["selected"].cpu(), "features": out["feat"].detach().cpu(),
           "kmeans_rows": seen["rows"], "kmeans_centroids": seen["centroids"],
           "metrics": {k: float(v.detach()) for k, v in metrics.items()}}
    del tr, out
    torch.cuda.empty_cache()
    return row


def dist_child_variants(rank: int, world: int, backend: str, port: int, out_dir: str) -> None:
    """(e), (g), (h) on one rank of ``world``: every variant config across
    the ranks, then NewVQ's stage 1, under deterministic algorithms (the
    k-means' sums are atomics otherwise, and differ from process to
    process)."""
    import torch.distributed as dist

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.allow_tf32 = False
    from equss_tpu_torch.parallel import mesh

    mesh.init_distributed(f"localhost:{port}", world, rank, device="cuda", backend=backend)
    try:
        out = {name: dist_variant_case(i, name, ranks_equal=True)
               for i, (name, *_) in enumerate(VARIANTS)}
        out["stage1"] = dist_stage1_case()
        out["device"] = str(mesh.local_device("cuda"))
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"variants_rank{rank}.pt"))
    if FAILURES:
        raise RuntimeError(f"variants rank {rank}: {FAILURES}")


def dist_child_variants_nccl1(out_path: str, port: int) -> None:
    """(f): the configs of ``DIST_VARIANT_NCCL1`` without a process group,
    then the same in a one-rank NCCL group, under deterministic
    algorithms."""
    import torch.distributed as dist

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.allow_tf32 = False
    cases = [(i, name) for i, (name, *_) in enumerate(VARIANTS)
             if name.startswith(DIST_VARIANT_NCCL1)]
    out = {"alone": {name: dist_variant_case(i, name, False, valid=False)
                     for i, name in cases}}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        out["grouped"] = {name: dist_variant_case(i, name, False, valid=False)
                          for i, name in cases}
    finally:
        dist.destroy_process_group()
    torch.save(out, out_path)
    if FAILURES:
        raise RuntimeError(f"variants nccl1: {FAILURES}")


def dist_short(name: str) -> str:
    return name.replace("_cocostuff27", "")


def dist_variants_report(results: dict, ranks: list, alone: dict, smi: str,
                         backend: str) -> None:
    """(e), (g), (h): the ranks against the one-process run on the same
    card, checked and printed, their launches into the kernels line."""
    for name, _, _, attn, _ in VARIANTS:
        short, want = dist_short(name), alone[name]
        got = [rk[name] for rk in ranks]
        equal = all(all(g["equal"]) for g in got) and all(
            torch.equal(g["state"], got[0]["state"]) for g in got)
        check(equal, f"dist variants {short}: ranks' states differ")
        rel_steps = [{k: abs(m[k] - a[k]) / max(abs(a[k]), 1e-12)
                      for k in DIST_LOSS_TERMS if k in a}
                     for m, a in zip(got[0]["metrics"], want["metrics"])]
        rel = {k: max(r[k] for r in rel_steps) for k in rel_steps[0]}
        cos = {k: torch.nn.functional.cosine_similarity(
                   got[0]["grads"][k].double(), want["grads"][k].double(), dim=0).item()
               for k in want["grads"]}
        check(all(v <= 1e-3 for v in rel.values()),
              f"dist variants {short}: loss terms vs one process by step {rel_steps}")
        check(min(cos.values()) >= 0.999, f"dist variants {short}: gradient cosine {cos}")
        feats = torch.cat([g["features"] for g in got])
        feat_equal = (feats == want["features"]).float().mean().item()
        feat_diff = (feats - want["features"]).abs().max().item()
        per_step = {"attention_qkv": attn}
        check(all(g["launches"] == expected(per_step, DIST_VARIANT_STEPS) for g in got),
              f"dist variants {short}: launches {[g['launches'] for g in got]}")
        results["launches"][f"dist_variants_{short}"] = {
            k: sum(g["launches"][k] for g in got) for k in got[0]["launches"]}
        row = {"phase": "distributed", "case": "variants", "config": name,
               "backend": backend, "world": len(ranks), "batch_global": DIST_VARIANT_BATCH,
               "steps": DIST_VARIANT_STEPS, "ranks_bit_equal_each_step": equal,
               "features_equal_share": feat_equal, "features_max_abs_diff": feat_diff,
               "loss_rel_diff_vs_one_process": rel, "loss_rel_diff_by_step": rel_steps,
               "losses_ranks": [{k: m[k] for k in rel} for m in got[0]["metrics"]],
               "losses_one_process": [{k: m[k] for k in rel} for m in want["metrics"]],
               "grad_cosine_vs_one_process": cos,
               "ms_per_step_ranks": got[0]["ms"], "ms_per_step_one_process": want["ms"],
               "launches_per_step_per_rank": {k: v / DIST_VARIANT_STEPS for k, v in
                                              got[0]["launches"].items()}}
        if "valid" in want:
            v_want = want["valid"]
            agree = {k: (torch.cat([g["valid"][k] for g in got]) == v_want[k]).float()
                     .mean().item() for k in ("linear_preds", "cluster_preds")}
            # each launch's indices: a rank's rows against the one-process
            # run's rows of the same images
            idx_equal, idx_share = [], []
            for j, w in enumerate(v_want["pq_indices"]):
                rows = w.shape[0] // len(ranks)
                idx_equal += [torch.equal(g["valid"]["pq_indices"][j],
                                          w[r * rows:(r + 1) * rows])
                              for r, g in enumerate(got)]
                idx_share.append((torch.cat([g["valid"]["pq_indices"][j] for g in got]) == w)
                                 .float().mean().item())
            check(min(agree.values()) >= 0.9999 and all(idx_equal),
                  f"dist variants {short} valid: pixels equal {agree}, indices equal "
                  f"{idx_equal} ({idx_share})")
            pq_launches, _ = pq_valid(name)
            per_valid = {"attention_qkv": 12, "pq_assign": pq_launches}
            check(all(g["valid"]["launches"] == expected(per_valid, 1) for g in got),
                  f"dist variants {short} valid: launches "
                  f"{[g['valid']['launches'] for g in got]}")
            valid_counts = [g["valid"]["launches"] for g in got]
            results["launches"][f"dist_variants_{short}_valid"] = {
                k: sum(c[k] for c in valid_counts) for k in valid_counts[0]}
            row.update(valid_pixels_equal=agree, valid_pq_indices_equal_by_rank=idx_equal,
                       valid_pq_indices_equal_share=idx_share)
        emit(row)
    got, want = [rk["stage1"] for rk in ranks], alone["stage1"]
    feats = torch.cat([g["features"] for g in got])
    s1_feat_equal = (feats == want["features"]).float().mean().item()
    s1_feat_diff = (feats - want["features"]).abs().max().item()
    same_sel = [torch.equal(g["selected"], want["selected"]) for g in got]
    sel_share = (got[0]["selected"] == want["selected"]).float().mean().item()
    # each centroid's n_kmeans rows as a set (their order within a
    # centroid follows ties of the distances)
    k = DIST_STAGE1_KMEANS
    sets = [g["selected"].reshape(-1, k).sort(-1).values for g in got]
    want_sets = want["selected"].reshape(-1, k).sort(-1).values
    set_share = (sets[0] == want_sets).all(-1).float().mean().item()
    km_rows_equal = (got[0]["kmeans_rows"] == want["kmeans_rows"]).float().mean().item()
    km_cents_diff = (got[0]["kmeans_centroids"] - want["kmeans_centroids"]).abs().max().item()
    rel = {k: abs(got[0]["metrics"][k] - v) / max(abs(v), 1e-12)
           for k, v in want["metrics"].items() if k in DIST_LOSS_TERMS}
    check(all(same_sel) and all(v <= 1e-3 for v in rel.values()),
          f"dist variants stage1: selection equal {same_sel} ({sel_share}), losses {rel}")
    check(all(g["launches"] == expected(STOCK_TRAIN_KERNELS, 1) for g in got),
          f"dist variants stage1: launches {[g['launches'] for g in got]}")
    results["launches"]["dist_variants_stage1"] = {
        k: sum(g["launches"][k] for g in got) for k in got[0]["launches"]}
    emit({"phase": "distributed", "case": "variants_stage1", "config": "new_vq_cocostuff27",
          "n_kmeans": DIST_STAGE1_KMEANS, "batch_global": DIST_VARIANT_BATCH,
          "rows_selected": int(want["selected"].numel()), "selection_equal_by_rank": same_sel,
          "selection_equal_share": sel_share, "centroid_sets_equal_share": set_share,
          "kmeans_rows_equal_share": km_rows_equal, "kmeans_centroids_max_abs_diff": km_cents_diff,
          "loss_rel_diff_vs_one_process": rel,
          "features_equal_share": s1_feat_equal, "features_max_abs_diff": s1_feat_diff,
          "ms_ranks": got[0]["ms"], "ms_one_process": want["ms"],
          "devices": [rk["device"] for rk in ranks], "nvidia_smi": smi,
          "note": "gloo carries CUDA tensors through the host: not a speed figure"
          if backend == "gloo" else ""})


def phase_distributed_variants(results: dict, ctx, tmp: str, smi: str) -> None:
    """(e)-(h) of ``phase_distributed``."""
    from equss_tpu_torch.parallel import mesh

    out = os.path.join(tmp, "variants_nccl1.pt")
    if dist_spawn(ctx, [(dist_child_variants_nccl1, (out, dist_free_port()))],
                  "variants nccl1", DIST_VARIANT_TIMEOUT_S):
        r = torch.load(out, weights_only=False)
        for name, alone in r["alone"].items():
            grouped, short = r["grouped"][name], dist_short(name)
            same_losses = all(a[k] == g[k] for a, g in zip(alone["metrics"], grouped["metrics"])
                              for k in DIST_LOSS_TERMS if k in a)
            same_state = torch.equal(alone["state"], grouped["state"])
            check(same_losses and same_state, f"dist variants nccl1 {short}: not bit-equal "
                  f"(losses {same_losses}, state {same_state})")
            results["launches"][f"dist_variants_nccl1_{short}"] = grouped["launches"]
            emit({"phase": "distributed", "case": "variants_nccl1", "config": name,
                  "backend": "nccl", "world": 1, "batch": DIST_VARIANT_BATCH,
                  "steps": DIST_VARIANT_STEPS, "bit_equal_losses": same_losses,
                  "bit_equal_state": same_state, "ms_per_step_alone": alone["ms"],
                  "ms_per_step_nccl1": grouped["ms"], "deterministic_algorithms": True})
    world = 2
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    port = dist_free_port()
    ok = dist_spawn(ctx, [(dist_child_variants, (r, world, backend, port, tmp))
                          for r in range(world)], "variants", DIST_VARIANT_TIMEOUT_S)
    check(not mesh.in_group(), "dist variants: the main process joined a group")
    # the one-process run under deterministic algorithms too, as the ranks
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        alone = {name: dist_variant_case(i, name, ranks_equal=False)
                 for i, (name, *_) in enumerate(VARIANTS)}
        alone["stage1"] = dist_stage1_case()
    finally:
        torch.use_deterministic_algorithms(was)
    if ok:
        ranks = [torch.load(os.path.join(tmp, f"variants_rank{r}.pt"), weights_only=False)
                 for r in range(world)]
        dist_variants_report(results, ranks, alone, smi, backend)


def phase_distributed(results: dict) -> None:
    """The port's data parallelism (``parallel/mesh.py``) on the card,
    ranks started with ``torch.multiprocessing`` (spawn) on a free
    localhost port:

    (a) one rank in an NCCL group against the same 10 pqgo ``kernel``
        steps at b = 16 without a group: losses and state bit-equal,
        both step medians over the last 8 and one all-reduce of the
        gradient's size;
    (b) two ranks (NCCL on two cards where there are two, else gloo on
        the one card, through the host), the global b = 16, 8 rows a
        rank: the ranks' state bit-equal after every step; against the
        one-process run on the global batch each loss term within 1e-3
        relative and the first step's head and codebook gradient cosine
        >= 0.999;
    (c) a vq step on the same two ranks: the EMA counts equal to the
        one-process run's;
    (d) ``build_sharded_predict_fn`` over the visible cards (two replicas
        on the one card where there is one) against ``build_predict_fn``
        on 8 images: >= 99.99% of pixels equal;
    (e)-(h) the variants across ranks (``phase_distributed_variants``):
    (f) one rank in an NCCL group against no group, ``DIST_VARIANT_NCCL1``
        for ``DIST_VARIANT_STEPS`` steps (``contra``'s ``data_init``
        first), deterministic algorithms: losses and state bit-equal;
    (e) two ranks as in (b), every config of ``VARIANTS`` at its widths,
        the global b = ``DIST_VARIANT_BATCH`` (2 rows a rank), the first
        batch's ``data_init`` where the model needs one and
        ``DIST_VARIANT_STEPS`` steps, under deterministic algorithms on
        both sides: the ranks' state bit-equal after each; against one
        process on the same card the first batch's backbone features
        compared, each loss term of every step within 1e-3 relative and
        the first step's gradient of each parameter group cosine >=
        0.999; the launches of every step;
    (g) on the same ranks first, the valid step at 320^2 of
        ``DIST_VARIANT_VALID``: >= 99.99% of predictions equal to the
        one-process valid step, each rank's indices of each PQ launch
        equal to the one-process rows of its images;
    (h) NewVQ's stage 1 (``n_kmeans`` ``DIST_STAGE1_KMEANS``) for one step
        on the same ranks: the selected rows equal to the one-process
        run's, each loss term within 1e-3 relative."""
    import torch.multiprocessing as mp

    from equss_tpu_torch import launch_counts, reset_launch_counts, serve
    from equss_tpu_torch.data.synthetic import synthetic_batches
    from equss_tpu_torch.parallel import mesh
    from equss_tpu_torch.train.trainer import Trainer

    ctx = mp.get_context("spawn")
    # the ranks are processes of their own: leave them the card's memory
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    t_phase = time.perf_counter()
    try:
        # (a)
        out = os.path.join(tmp, "nccl1.pt")
        if dist_spawn(ctx, [(dist_child_nccl1, (out, dist_free_port()))], "nccl1"):
            r = torch.load(out, weights_only=False)
            alone, grouped = r["alone"], r["grouped"]
            keys = ("loss", "stego-loss", "vq-loss", "linear-loss", "cluster-loss")
            same_losses = all(a[k] == g[k] for a, g in zip(alone["metrics"], grouped["metrics"])
                              for k in keys)
            same_state = torch.equal(alone["state"], grouped["state"])
            check(same_losses and same_state, "distributed nccl1: not bit-equal to the "
                  f"steps without a group (losses {same_losses}, state {same_state})")
            steps = DIST_NCCL1_WARM + DIST_NCCL1_TIMED
            check(grouped["launches"] == expected(FUSED_LN_KERNELS, steps),
                  f"distributed nccl1: launches {grouped['launches']}")
            results["launches"]["dist_nccl1"] = grouped["launches"]
            timed = {k: sorted(r[k]["ms"][DIST_NCCL1_WARM:]) for k in ("alone", "grouped")}
            emit({"phase": "distributed", "case": "nccl1", "backend": "nccl", "world": 1,
                  "batch": DIST_BATCH, "steps": steps, "steps_timed": DIST_NCCL1_TIMED,
                  "bit_equal_losses": same_losses, "bit_equal_state": same_state,
                  "ms_per_step_median_alone": timed["alone"][DIST_NCCL1_TIMED // 2],
                  "ms_per_step_median_nccl1": timed["grouped"][DIST_NCCL1_TIMED // 2],
                  "ms_per_step_alone": alone["ms"], "ms_per_step_nccl1": grouped["ms"],
                  "gradient_all_reduce_ms": r["bucket_ms"],
                  "gradient_numel": r["bucket_numel"], "deterministic_algorithms": True,
                  "nvidia_smi": smi})
            for what, prof in r["profiles"].items():
                emit({"phase": "profile", "what": f"distributed_{what}", "batch": DIST_BATCH,
                      "steps": 2, **prof})

        # (b), (c)
        world = 2
        two_cards = torch.cuda.device_count() >= 2
        backend = "nccl" if two_cards else "gloo"
        port = dist_free_port()
        ok = dist_spawn(ctx, [(dist_child_ranks, (r, world, backend, port, tmp))
                              for r in range(world)], "ranks")
        batches = list(synthetic_batches(0, DIST_STEPS, DIST_BATCH, res=224, num_classes=27))
        _, tr = train_model("kernel")
        tr.forward_backward(batches[0])
        want_grads = dist_grads(tr)
        _, tr = train_model("kernel")
        alone = dist_steps(tr, batches)
        cfg = preset("vq_cocostuff27")
        vq = Trainer(cfg, device="cuda", seed=0)
        vq.train_step(batches[0])
        want_counts = {k: vq.model.pq_state.as_dict()[k].cpu() for k in ("vq_count", "ema_count")}
        del vq
        if ok:
            ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                     for r in range(world)]
            r0 = ranks[0]
            equal = all(all(rk["steps"]["ranks_equal"]) for rk in ranks)
            states_equal = all(torch.equal(rk["steps"]["state"], r0["steps"]["state"])
                               for rk in ranks)
            check(equal and states_equal, "distributed ranks: states differ between ranks")
            rel = {k: max(abs(m[k] - a[k]) / max(abs(a[k]), 1e-12)
                          for m, a in zip(r0["steps"]["metrics"], alone["metrics"]))
                   for k in LOSS_TERMS if k in alone["metrics"][0]}
            cos = {k: torch.nn.functional.cosine_similarity(
                       r0["grads"][k].flatten().double(), want_grads[k].flatten().double(),
                       dim=0).item() for k in want_grads}
            check(all(v <= 1e-3 for v in rel.values()),
                  f"distributed ranks: loss terms vs one process {rel}")
            check(min(cos.values()) >= 0.999, f"distributed ranks: gradient cosine {cos}")
            per_step = expected(FUSED_LN_KERNELS, DIST_STEPS)
            check(all(rk["steps"]["launches"] == per_step for rk in ranks),
                  f"distributed ranks: launches {[rk['steps']['launches'] for rk in ranks]}")
            results["launches"]["dist_ranks"] = {
                k: sum(rk["steps"]["launches"][k] for rk in ranks) for k in per_step}
            counts_equal = all(torch.equal(rk["vq_counts"][k], want_counts[k])
                               for rk in ranks for k in want_counts)
            count_l1 = float((r0["vq_counts"]["vq_count"] - want_counts["vq_count"]).abs().sum())
            check(counts_equal and all(rk["vq_ranks_equal"] for rk in ranks),
                  f"distributed vq: EMA counts differ from one process (L1 {count_l1})")
            emit({"phase": "distributed", "case": "ranks", "backend": backend, "world": world,
                  "devices": [rk["device"] for rk in ranks], "batch_global": DIST_BATCH,
                  "steps": DIST_STEPS, "ranks_bit_equal_each_step": equal and states_equal,
                  "loss_rel_diff_vs_one_process": rel, "grad_cosine_vs_one_process": cos,
                  "ms_per_step_median_ranks": sorted(r0["steps"]["ms"])[DIST_STEPS // 2],
                  "ms_per_step_median_one_process": sorted(alone["ms"])[DIST_STEPS // 2],
                  "ms_per_step_ranks": r0["steps"]["ms"], "ms_per_step_one_process": alone["ms"],
                  "launches_per_step_per_rank": {k: v / DIST_STEPS for k, v in
                                                 r0["steps"]["launches"].items()},
                  "vq_counts_equal": counts_equal, "vq_count_l1": count_l1,
                  "vq_count_sum": float(r0["vq_counts"]["vq_count"].sum()),
                  "nvidia_smi": smi,
                  "note": "gloo carries CUDA tensors through the host: not a speed figure"
                  if backend == "gloo" else ""})

        # (d)
        devices = mesh.make_mesh() if two_cards else [torch.device("cuda", 0)] * 2
        img = torch.rand((8, 224, 224, 3), generator=torch.Generator().manual_seed(5)).cuda()
        want = serve.build_predict_fn(tr)(img)
        sharded = serve.build_sharded_predict_fn(tr, devices)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = sharded(img)
        torch.cuda.synchronize()
        counts = launch_counts()
        results["launches"]["dist_serve"] = counts
        check(counts == expected(FUSED_LN_KERNELS, len(devices)),
              f"distributed serve: launches {counts}")
        agree = {k: (got[k] == want[k]).float().mean().item() for k in want}
        check(set(got) == set(want) and min(agree.values()) >= 0.9999,
              f"distributed serve: pixels equal {agree}")
        emit({"phase": "distributed", "case": "sharded_serve",
              "devices": [str(d) for d in devices], "batch": 8, "pixels_equal": agree})
        del tr, sharded
        gc.collect()
        torch.cuda.empty_cache()
        t_variants = time.perf_counter()
        phase_distributed_variants(results, ctx, tmp, smi)
        emit({"phase": "distributed", "case": "seconds",
              "seconds_variants": time.perf_counter() - t_variants,
              "seconds_phase": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------- tensor parallelism
# the kernel against itself: (name, n, M, K, d, normalize, exact); each
# runs on 2 and 4 K-shards, merged, against one launch over the codebook
TP_KERNEL_CASES = [
    ("narrow_fast_n12544", 12544, 64, 256, 16, "l2", False),
    ("narrow_fast_n100352", 100352, 64, 256, 16, "l2", False),
    ("narrow_exact_n12544", 12544, 64, 256, 16, "l2", True),
    ("fast_k512", 16384, 64, 512, 16, "l2", False),
    ("z_trainable_fast", 12544, 64, 256, 16, "z_trainable", False),
    ("wide_fast_vq", 12800, 1, 256, 1024, "none", False),
    ("wide_fast_new_vq", 12800, 8, 2048, 64, "none", False),
    ("wide_exact_unseg", 12800, 1, 2048, 384, "none", True),
    ("wide_exact_contra", 51200, 4, 1024, 128, "l2", True),
]
# the kernels line's shard row: the preset's train step on a 1 x 2 grid,
# each rank's launch on its half of the codebook
TP_ROW_CASE = ("train_fast_l2_half", 16 * 28 * 28, 64, 256, 16, "l2", False)


def tp_merge(outs: list, K: int, exact: bool):
    """One process's merge of shard launches ``outs`` ((idx, z_norm, z_q,
    key) each): the least ``merge_key``, its index, and z_q from the shard
    that owns it."""
    from equss_tpu_torch.ops.pq_assign import merge_key, packed_keys

    packed = packed_keys(K, exact)
    win = torch.stack([merge_key(o[3], o[0], packed) for o in outs]).amin(0)
    idx = (win & 0xFFFFFFFF).to(torch.int32)
    owner = torch.stack([o[0] for o in outs]) == idx
    zq = torch.stack([o[2] for o in outs])
    return idx, zq.gather(0, owner.int().argmax(0)[None, ..., None].expand(1, *zq.shape[1:]))[0]


def phase_tp_kernel(results: dict) -> None:
    """``pq_assign_shard`` on 2 and 4 K-shards of each ``TP_KERNEL_CASES``
    codebook, merged (``tp_merge``), against one ``pq_assign`` launch over
    the whole codebook: indices and z_q bit-equal, z_norm bit-equal on
    every shard; each shard launch against its plain version
    (``pq_assign_shard_reference``): index agreement >= 99.99% (exact) or
    99.5% (fast); a packed key's low byte is its index, an ordered key a
    finite distance's.  Then the kernels
    line's row ``TP_ROW_CASE``: the shard launch's time, its plain
    version's, normalise + ``torch.cdist`` + ``argmin`` + gather on the
    shard (the library call) and the bound."""
    from equss_tpu_torch.ops.pq_assign import (
        KEY_INF,
        kernel_body,
        packed_keys,
        pq_assign,
        pq_assign_shard,
        pq_assign_shard_reference,
    )
    from equss_tpu_torch.tools.pq_ab import case_inputs, library_call

    g = torch.Generator(device="cuda").manual_seed(7)
    t0 = time.perf_counter()
    rows = []
    for name, n, M, K, d, mode, exact in TP_KERNEL_CASES:
        z, cn, cb, zm, zs = case_inputs(n, M, K, d, mode, g)
        kw = dict(normalize=mode, z_mean=zm, z_std=zs, exact=exact)
        idx, zn, zq = pq_assign(z, cn, cb, **kw)
        row = {"case": name, "n": n, "M": M, "K": K, "d": d, "normalize": mode, "exact": exact,
               "body": kernel_body(d, K, exact)}
        for m in (2, 4):
            Kp = K // m
            outs, agree = [], []
            for r in range(m):
                part = slice(r * Kp, (r + 1) * Kp)
                args = (z, cn[:, part].contiguous(), cb[:, part].contiguous(), r * Kp, K)
                out = pq_assign_shard(*args, **kw)
                ref = pq_assign_shard_reference(*args, **kw)
                agree.append((out[0] == ref[0]).float().mean().item())
                check(torch.equal(out[1], zn), f"tp kernel {name}/{m}: z_norm of shard {r}")
                # a packed key carries its index; an ordered one a finite distance
                if packed_keys(K, exact):
                    keys_ok = torch.equal(out[3] & 0xFF, out[0].long() & 0xFF)
                else:
                    keys_ok = bool((out[3] < KEY_INF).all())
                check(keys_ok, f"tp kernel {name}/{m}: keys of shard {r}")
                outs.append(out)
            need = 0.9999 if exact else 0.995
            check(min(agree) >= need, f"tp kernel {name}/{m}: index agreement {agree}")
            m_idx, m_zq = tp_merge(outs, K, exact)
            idx_eq, zq_eq = torch.equal(m_idx, idx), torch.equal(m_zq, zq)
            check(idx_eq and zq_eq, f"tp kernel {name}/{m}: merged shards not bit-equal to one "
                  f"launch (indices {idx_eq}, z_q {zq_eq}, "
                  f"{int((m_idx != idx).sum())} indices differ)")
            row[f"shards_{m}"] = {"indices_bit_equal": idx_eq, "z_q_bit_equal": zq_eq,
                                  "index_agreement_vs_plain": agree}
        emit({"phase": "tensor_parallel", "case": "kernel", **row})
        rows.append(row)
        del z, cn, cb, idx, zn, zq, outs
        torch.cuda.empty_cache()
    results["tp_kernel_rows"] = rows

    name, n, M, K, d, mode, exact = TP_ROW_CASE
    z, cn, cb, zm, zs = case_inputs(n, M, K, d, mode, g)
    Kp = K // 2
    args = (z, cn[:, :Kp].contiguous(), cb[:, :Kp].contiguous(), 0, K)
    kw = dict(normalize=mode, exact=exact)
    out, ref = pq_assign_shard(*args, **kw), pq_assign_shard_reference(*args, **kw)
    agree = (out[0] == ref[0]).float().mean().item()
    ms = cuda_ms(lambda: pq_assign_shard(*args, **kw), iters=10)
    plain = cuda_ms(lambda: pq_assign_shard_reference(*args, **kw), iters=3)
    lib = cuda_ms(lambda: library_call(z, args[1], args[2], mode), iters=3)
    nbytes = 4.0 * (n * M * d + 2 * M * Kp * d + n * M + 2 * n * M * d) + 8.0 * n * M
    bnd, by = bound_ms(2.0 * n * M * Kp * d, PEAK_BF16_FLOPS, nbytes)
    row = {"phase": "kernel", "kernel": "pq_assign_shard", "case": name, "n": n, "M": M,
           "K_shard": Kp, "K_total": K, "d": d, "normalize": mode, "exact": exact,
           "index_agreement": agree, "max_abs_err": (out[1] - ref[1]).abs().max().item(),
           "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd, "bound_by": by,
           "share_of_bound": bnd / ms}
    check(agree >= 0.995, f"tp kernel row: index agreement {agree}")
    emit(row)
    results["pq_assign_shard"] = row
    emit({"phase": "tensor_parallel", "case": "kernel_seconds",
          "seconds": time.perf_counter() - t0})


# the preset on (data, model) grids of ranks on the card(s)
TP_GRIDS = ((1, 2), (2, 2))
TP_LAYOUTS = ("quantizer", "quantizer_backbone")
TP_SERVE, TP_VALID, TP_TRAIN = 16, 8, 16      # global batches: serving, valid, train
TP_STEPS = 3
TP_TIMEOUT_S = 420
# the kernels of each path, per forward or step, with the quantizer sharded
TP_KERNELS = {"attention_qkv": 12, "layernorm": 1, "add_layernorm": 24, "pq_assign_shard": 1}


def tp_inputs() -> dict:
    """The global inputs of the phase: serving images (uint8, 224^2), the
    valid batch (320^2) and the train batches (224^2 with positives)."""
    from equss_tpu_torch.data.synthetic import synthetic_batches

    return {"serve": requests(TP_SERVE, 1, 20)[0], "valid": valid_batches(1, TP_VALID, 21)[0],
            "train": list(synthetic_batches(22, TP_STEPS, TP_TRAIN, res=224, num_classes=27))}


def tp_rows(batch, index: int, parts: int):
    """Rows ``index`` of ``parts`` of a batch (a tensor or a dict of arrays)."""
    if torch.is_tensor(batch) or isinstance(batch, np.ndarray):
        n = batch.shape[0] // parts
        return batch[index * n:(index + 1) * n]
    return {k: tp_rows(v, index, parts) for k, v in batch.items()}


def tp_infer(tr, inputs: dict, index: int, parts: int) -> dict:
    """Serving, the exact-mode indices of the same images and the valid
    step of one trainer on rows ``index`` of ``parts`` of the global
    inputs (the whole batch with parts = 1, so one process runs the same
    function), inside the global program; the launches of each path."""
    from equss_tpu_torch import launch_counts, reset_launch_counts, serve
    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.ops.quantizer import pq_forward
    from equss_tpu_torch.parallel import mesh

    out = {}
    model = tr.model
    img = tp_rows(inputs["serve"], index, parts).to(tr.device)
    predict = serve.build_predict_fn(tr)
    torch.cuda.synchronize()
    with mesh.global_program():
        reset_launch_counts()
        preds = predict(img.float() / 255.0)
        torch.cuda.synchronize()
        out["serve_launches"] = launch_counts()
        with torch.no_grad():
            feat = model.features(normalize_images(img))
            code = model.encode(feat)
            pq_cfg = dataclasses.replace(model.cfg.pq, assign_precision="exact")
            exact_idx = pq_forward(code, dict(model.pq), model.pq_state.as_dict(), pq_cfg)[1]
            indices = model(normalize_images(img), training=False)["indices"]
    out["serve"] = {k: v.cpu() for k, v in preds.items()}
    out["feat"], out["exact_indices"], out["indices"] = feat.cpu(), exact_idx.cpu(), indices.cpu()
    reset_launch_counts()
    res = tr.valid_step(tp_rows(inputs["valid"], index, parts))
    torch.cuda.synchronize()
    out["valid_launches"] = launch_counts()
    out["valid"] = {k: res[k].cpu() for k in ("linear_preds", "cluster_preds", "pq_indices")}
    return out


def tp_train(tr, inputs: dict, index: int, parts: int) -> dict:
    """``TP_STEPS`` train steps on rows ``index`` of ``parts`` of the global
    train batches: the metrics, the launches and the first step's head and
    codebook gradients (the codebook's gathered whole)."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.parallel import mesh

    reset_launch_counts()
    metrics, grads = [], None
    for i, b in enumerate(inputs["train"]):
        t0 = time.perf_counter()
        metrics.append(tr.train_step(tp_rows(b, index, parts)))
        torch.cuda.synchronize()
        metrics[-1]["ms"] = 1e3 * (time.perf_counter() - t0)
        if i == 0:
            grads = {n: p.grad.detach() for n, p in tr.model_params
                     if n.startswith(("head.", "pq.codebook")) and p.grad is not None}
            grads = {n: g.cpu() for n, g in
                     mesh.gather_sharded(grads, mesh.sharded_layout(tr.model)).items()}
    return {"train_launches": launch_counts(), "metrics": metrics, "grads": grads}


class tp_split_mlp:
    """Inside: every ViT MLP of one process computes what ``parts`` model
    ranks compute after ``shard_backbone`` (``models/vit.py::Mlp``'s
    sharded branch): fc1 and GELU on each part of the hidden units, fc2's
    parts as f32 products of the bf16 operands, summed in rank order in
    f32, the bias added, one rounding.  ``parts`` = 1 is the control: the
    stock MLP with only fc2's f32 summation order changed."""

    def __init__(self, parts: int):
        self.parts = parts

    def __enter__(self):
        import torch.nn.functional as F

        from equss_tpu_torch.models import vit

        parts = self.parts

        def forward(mlp, x):
            dt = mlp.cfg.dtype
            k = mlp.hidden // parts
            acc = None
            for r in range(parts):
                cut = slice(r * k, (r + 1) * k)
                h = F.gelu(F.linear(x.to(dt), mlp.fc1.weight[cut].to(dt), mlp.fc1.bias[cut].to(dt)),
                           approximate="tanh" if mlp.cfg.gelu_approximate else "none")
                part = F.linear(h.float(), mlp.fc2.weight[:, cut].to(dt).float())
                acc = part if acc is None else acc + part
            return (acc + mlp.fc2.bias.to(dt).float()).to(dt)

        self.saved = vit.Mlp.forward
        vit.Mlp.forward = forward
        return self

    def __exit__(self, *exc):
        from equss_tpu_torch.models import vit

        vit.Mlp.forward = self.saved


def tp_replicated_equal(tr) -> bool:
    """Whether every whole tensor of the trainer (model, probes, optimizer
    moments) equals the first rank's of its model group bit for bit."""
    import torch.distributed as dist

    from equss_tpu_torch.parallel import mesh

    layout = mesh.sharded_layout(tr.model)
    parts = [t.detach().float().reshape(-1) for n, t in tr.model.state_dict().items()
             if n not in layout]
    parts += [t.detach().float().reshape(-1) for t in tr.evaluator.state_dict().values()]
    for name, st in tr.tx_model.state_dict()["state"].items():
        if name not in layout:
            parts += [t.float().reshape(-1) for t in st.values() if torch.is_tensor(t)]
    mine = torch.cat([t.cpu() for t in parts])
    ref = mine.clone()
    group = mesh.grid().model_group
    dist.broadcast(ref, src=dist.get_global_rank(group, 0), group=group)
    return torch.equal(mine, ref)


def tp_child(rank: int, world: int, data: int, model: int, backend: str, port: int,
             out_dir: str) -> None:
    """One rank of a ``data`` x ``model`` grid: for each of ``TP_LAYOUTS``
    the preset (``kernel``: the PQ kernel's training route, fused LN) with
    its quantizer sharded (and its backbone's MLPs), ``tp_infer`` and
    ``tp_train`` on this data rank's rows, whether its whole state equals
    its model group's first rank's, and (rank 0) the gathered
    ``state_dict``."""
    import torch.distributed as dist

    from equss_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    mesh.init_distributed(f"localhost:{port}", world, rank, device="cuda", backend=backend)
    try:
        grid = mesh.make_mesh_2d(data, model)
        dev = str(mesh.local_device("cuda"))
        inputs = tp_inputs()
        out = {"place": (grid.data_index, grid.model_index), "device": dev}
        for layout in TP_LAYOUTS:
            _, tr = train_model("kernel", device=dev, grid=grid)
            mesh.shard_quantizer(grid, tr.model)
            if layout == "quantizer_backbone":
                mesh.shard_backbone(grid, tr.model)
            res = tp_infer(tr, inputs, grid.data_index, grid.data)
            res.update(tp_train(tr, inputs, grid.data_index, grid.data))
            if layout == "quantizer":
                # the shard launches in path: every rank runs the profiled steps
                vrows = tp_rows(inputs["valid"], grid.data_index, grid.data)
                res["valid_profile"] = device_profile(lambda: tr.valid_step(vrows), 2,
                                                      pick=("pq_",))
            res["replicated_equal"] = tp_replicated_equal(tr)
            res["layout"] = mesh.sharded_layout(tr.model)
            sd = tr.state_dict()
            if rank == 0:
                torch.save({k: v.cpu() for k, v in sd.items()},
                           os.path.join(out_dir, f"tp_{data}x{model}_{layout}_sd.pt"))
            out[layout] = res
            del tr, sd
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"tp_{data}x{model}_{rank}.pt"))
    if FAILURES:
        raise RuntimeError(f"tp rank {rank}: {FAILURES}")


def tp_agree(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a == b).float().mean().item()


def tp_check_grid(results: dict, data: int, model: int, ranks: list, one: dict, smi: str,
                  backend: str) -> None:
    """The bars of one grid against one process on the same rows (serving,
    exact indices, valid) and on the global batch (train)."""
    g = f"{data}x{model}"
    for layout in TP_LAYOUTS:
        sharded_bb = layout == "quantizer_backbone"
        rows = {}
        for r, rk in enumerate(ranks):
            res, i = rk[layout], rk["place"][0]
            ref = one[("rows", i, data)]
            first = ranks[i * model][layout]
            same_group = all(torch.equal(res[k], first[k])
                             for k in ("feat", "indices", "exact_indices")) and all(
                torch.equal(res["serve"][k], first["serve"][k]) for k in res["serve"])
            check(same_group and res["replicated_equal"],
                  f"tp {g} {layout} rank {r}: not alike its model group's first rank")
            pixels = min(tp_agree(res["serve"][k], ref["serve"][k]) for k in ref["serve"])
            idx = tp_agree(res["indices"], ref["indices"])
            valid = min(tp_agree(res["valid"][k], ref["valid"][k])
                        for k in ("linear_preds", "cluster_preds"))
            valid_idx = tp_agree(res["valid"]["pq_indices"], ref["valid"]["pq_indices"])
            feat_err = (res["feat"] - ref["feat"]).abs().max().item()
            ulp = bf16_ulp(ref["feat"])
            extra = {}
            if sharded_bb:
                # bit-equal to one process running the same split arithmetic;
                # against the stock MLP the serving correctness class
                split = one[("split", i, data)]
                same = (torch.equal(res["feat"], split["feat"])
                        and torch.equal(res["indices"], split["indices"])
                        and torch.equal(res["valid"]["pq_indices"], split["valid"]["pq_indices"])
                        and all(torch.equal(res["serve"][k], split["serve"][k])
                                for k in split["serve"]))
                rel_err = ((res["feat"] - ref["feat"]).abs().mean()
                           / ref["feat"].abs().mean()).item()
                check(same, f"tp {g} {layout}: not bit-equal to one process's split MLPs")
                check(idx >= 0.95 and rel_err <= 2e-2,
                      f"tp {g} {layout}: vs the stock MLPs indices {idx}, rel. error {rel_err}")
                extra = {"bit_equal_to_split_one_process": same, "feature_mean_rel_err": rel_err,
                         "one_ulp_bar_met": feat_err <= ulp and idx >= 0.999 and valid_idx >= 0.999}
            else:
                exact_eq = torch.equal(res["exact_indices"], ref["exact_indices"])
                check(exact_eq and torch.equal(res["feat"], ref["feat"]),
                      f"tp {g} {layout}: exact indices bit-equal {exact_eq}")
                check(pixels >= 0.9999 and valid >= 0.9999,
                      f"tp {g} {layout}: pixels equal {pixels}, valid {valid} < 99.99%")
            rows[r] = {"serve_pixels_equal": pixels, "indices_equal": idx,
                       "exact_indices_bit_equal": torch.equal(res["exact_indices"],
                                                              ref["exact_indices"]),
                       "valid_pixels_equal": valid, "valid_indices_equal": valid_idx,
                       "feature_max_abs_diff": feat_err, "feature_bf16_ulp": ulp, **extra}
            for what, per in (("serve", 1), ("valid", 1), ("train", TP_STEPS)):
                check(res[f"{what}_launches"] == expected(TP_KERNELS, per),
                      f"tp {g} {layout} {what}: launches {res[f'{what}_launches']}")
        r0, whole = ranks[0][layout], one["global"]
        rel = {k: max(abs(m[k] - a[k]) / max(abs(a[k]), 1e-12)
                      for m, a in zip(r0["metrics"], whole["metrics"]))
               for k in LOSS_TERMS if k in whole["metrics"][0]}
        cos = {k: torch.nn.functional.cosine_similarity(
                   r0["grads"][k].flatten().double(), whole["grads"][k].flatten().double(),
                   dim=0).item() for k in whole["grads"]}
        check(all(v <= 1e-3 for v in rel.values()), f"tp {g} {layout}: loss terms {rel}")
        check(min(cos.values()) >= 0.999, f"tp {g} {layout}: gradient cosine {cos}")
        for what in ("serve", "valid", "train"):
            results["launches"][f"tp_{g}_{layout}_{what}"] = {
                k: sum(rk[layout][f"{what}_launches"][k] for rk in ranks)
                for k in ranks[0][layout][f"{what}_launches"]}
        if "valid_profile" in r0:
            # the shard launch of the valid step (rows of one data rank) in path
            n = TP_VALID // data * 40 * 40
            kp = 256 // model
            picked = [e for e in r0["valid_profile"]["picked"] if "pq_fast" in e["name"]]
            bnd, by = bound_ms(2.0 * n * 64 * kp * 16, PEAK_BF16_FLOPS,
                               4.0 * (n * 64 * 16 + 2 * 64 * kp * 16 + n * 64 + 2 * n * 64 * 16)
                               + 8.0 * n * 64)
            in_path = picked[0]["ms_per_call"] if picked else None
            check(in_path is not None, f"tp {g}: no shard launch in the valid profile")
            results.setdefault("tp_in_path", {})[g] = {
                "n": n, "K_shard": kp, "ms_per_launch": in_path, "bound_ms": bnd, "bound_by": by,
                "share_of_bound": bnd / in_path if in_path else None,
                "device_busy_share": r0["valid_profile"]["device_busy_share"]}
            emit({"phase": "profile", "what": f"tp_{g}_valid", **r0["valid_profile"],
                  "pq_assign_shard_in_path": results["tp_in_path"][g]})
        emit({"phase": "tensor_parallel", "case": f"grid_{g}", "layout": layout,
              "backend": backend, "devices": sorted({rk["device"] for rk in ranks}),
              "sharded": sorted(r0["layout"]), "ranks": rows,
              "loss_rel_diff_vs_one_process": rel, "grad_cosine_vs_one_process": cos,
              "ms_per_step_ranks": [m["ms"] for m in r0["metrics"]],
              "ms_per_step_one_process": [m["ms"] for m in whole["metrics"]],
              "launches_per_rank": {w: r0[f"{w}_launches"] for w in ("serve", "valid", "train")},
              "nvidia_smi": smi,
              "note": "gloo carries CUDA tensors through the host: not a speed figure"
              if backend == "gloo" else ""})


def tp_export(results: dict, tr, tmp: str) -> None:
    """A two-device artifact (``export.platforms=cuda,cpu``) of the preset,
    traced on the card: its CUDA member bit-equal to the live CUDA
    predictor, its CPU member equal to the live predictor of the same
    weights on the CPU, a device it does not list raises."""
    from equss_tpu_torch import launch_counts, reset_launch_counts, serve
    from equss_tpu_torch.models.equss import EQUSS
    from equss_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    img = requests(2, 1, 23)[0].float() / 255.0
    path = serve.save_predictor(serve.export_predictor(tr, (224, 224), batch_size=2,
                                                       platforms="cuda,cpu"),
                                os.path.join(tmp, "two.pt2"))
    live = serve.build_predict_fn(tr)(img.cuda())
    on_cuda = serve.load_predictor(path, device="cuda")
    reset_launch_counts()
    got = on_cuda(img)
    torch.cuda.synchronize()
    counts = launch_counts()
    results["launches"]["export_two_devices"] = counts
    cuda_eq = all(torch.equal(got[k], live[k]) for k in live)
    cpu_tr = Trainer(tr.cfg, device="cpu", model=EQUSS(tr.model.cfg, device="cpu", seed=0))
    cpu_tr.load_state_dict({k: v.cpu() for k, v in tr.state_dict().items()})
    live_cpu = serve.build_predict_fn(cpu_tr)(img)
    got_cpu = serve.load_predictor(path, device="cpu")(img)
    cpu_eq = all(torch.equal(got_cpu[k], live_cpu[k]) and got_cpu[k].device.type == "cpu"
                 for k in live_cpu)
    cuda_only = serve.save_predictor(serve.export_predictor(tr, (224, 224), batch_size=2),
                                     os.path.join(tmp, "cuda.pt2"))
    try:
        serve.load_predictor(cuda_only, device="cpu")
        unlisted_raises = False
    except ValueError:
        unlisted_raises = True
    check(cuda_eq and counts["pq_assign"] == 1 and counts["attention_qkv"] == 12,
          f"tp export: CUDA member equal {cuda_eq}, launches {counts}")
    check(cpu_eq, "tp export: the CPU member differs from the live CPU predictor")
    check(unlisted_raises, "tp export: an unlisted device did not raise")
    emit({"phase": "tensor_parallel", "case": "export_two_devices", "platforms": ["cuda", "cpu"],
          "cuda_member_bit_equal": cuda_eq, "cpu_member_equal": cpu_eq,
          "cuda_member_launches": counts, "unlisted_device_raises": unlisted_raises,
          "seconds": time.perf_counter() - t0})


def phase_tensor_parallel(results: dict) -> None:
    """Tensor parallelism (``parallel/mesh.py``: ``make_mesh_2d``,
    ``shard_quantizer``, ``shard_backbone``) on the card:

    (a) the shard kernel against itself and its plain version
        (``phase_tp_kernel``);
    (b) the preset on a 1 x 2 and a 2 x 2 grid of ranks started with
        ``torch.multiprocessing`` (gloo on the one card, NCCL where there are
        as many cards as ranks), each with the quantizer sharded, then with
        the backbone's MLPs sharded too (``tp_child``), against one process
        on the same card: serving b = 16 at 224^2 and the valid step at
        b = 8, 320^2 on each data rank's rows against one process on the
        same rows (>= 99.99% of pixels equal, exact-mode indices bit-equal
        with the quantizer alone sharded; with the MLPs sharded too,
        serving, features, indices and the valid step bit-equal to one
        process running the same split arithmetic (``tp_split_mlp``), and
        against the stock MLPs the serving correctness class: indices >=
        95%, features' mean relative error <= 2e-2, beside a control that
        changes only fc2's f32 summation order; whether 1 bf16 ulp and
        99.9% of indices held is printed), ``TP_STEPS`` train steps at the
        global b = 16 against one process on the global batch (loss terms
        <= 1e-3 relative, the first step's head and codebook gradient
        cosine >= 0.999), the model ranks
        of each data group alike in outputs and whole state, the launches
        of every path, and the gathered checkpoint loaded into one process;
    (c) the two-device export (``tp_export``).  The phase prints its
        seconds."""
    import gc

    import torch.multiprocessing as mp

    from equss_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    smi = nvidia_smi()
    phase_tp_kernel(results)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    ctx = mp.get_context("spawn")
    try:
        cards = torch.cuda.device_count()
        spawned = {}
        for data, model in TP_GRIDS:
            world = data * model
            backend = "nccl" if cards >= world else "gloo"
            procs = [ctx.Process(target=tp_child,
                                 args=(r, world, data, model, backend, port, tmp))
                     for port in [dist_free_port()] for r in range(world)]
            for p in procs:
                p.start()
            spawned[(data, model)] = (procs, backend)
        # one process on the same card meanwhile: the same rows of every data rank
        inputs = tp_inputs()
        _, tr = train_model("kernel")
        splits = sorted({d for d, _ in TP_GRIDS})
        one = {("rows", i, parts): tp_infer(tr, inputs, i, parts)
               for parts in splits for i in range(parts)}
        # the sharded MLPs' arithmetic in one process (every grid here has
        # 2 model ranks), and the control: the stock MLPs with fc2 summed
        # in another f32 order
        with tp_split_mlp(2):
            one.update({("split", i, parts): tp_infer(tr, inputs, i, parts)
                        for parts in splits for i in range(parts)})
        with tp_split_mlp(1):
            control = tp_infer(tr, inputs, 0, 1)
        stock = one[("rows", 0, 1)]
        emit({"phase": "tensor_parallel", "case": "mlp_order_control",
              "what": "one process: stock MLPs against fc2 as one f32 product, summed in "
                      "another order (no sharding)",
              "feature_max_abs_diff": (control["feat"] - stock["feat"]).abs().max().item(),
              "feature_bf16_ulp": bf16_ulp(stock["feat"]),
              "feature_elements_differing": (control["feat"] != stock["feat"]).float().mean().item(),
              "indices_equal": tp_agree(control["indices"], stock["indices"]),
              "serve_pixels_equal": min(tp_agree(control["serve"][k], stock["serve"][k])
                                        for k in stock["serve"])})
        one["global"] = tp_train(tr, inputs, 0, 1)
        deadline = time.time() + TP_TIMEOUT_S
        for (data, model), (procs, backend) in spawned.items():
            for p in procs:
                p.join(max(1.0, deadline - time.time()))
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(30)
            codes = [p.exitcode for p in procs]
            if not check(all(c == 0 for c in codes), f"tp {data}x{model}: exit codes {codes}"):
                continue
            ranks = [torch.load(os.path.join(tmp, f"tp_{data}x{model}_{r}.pt"), weights_only=False)
                     for r in range(data * model)]
            tp_check_grid(results, data, model, ranks, one, smi, backend)
            for layout in TP_LAYOUTS:
                sd = torch.load(os.path.join(tmp, f"tp_{data}x{model}_{layout}_sd.pt"))
                loaded = Trainer(tr.cfg, device="cuda", model=type(tr.model)(tr.model.cfg, seed=0))
                loaded.load_state_dict(sd)
                shapes = all(sd[k].shape == v.shape for k, v in tr.state_dict().items())
                check(shapes and set(sd) == set(tr.state_dict()),
                      f"tp {data}x{model} {layout}: the gathered checkpoint's names or shapes")
                del loaded
        _, fresh = train_model("kernel")
        tp_export(results, fresh, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "tensor_parallel", "case": "seconds", "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------- crf_compare

CRF_COMPARE = {"n_steps": 20, "batch_size": 8, "res": 224, "n_val": 2, "seed": 0}


def phase_crf_compare(results: dict) -> None:
    """``run_crf_compare`` on the card at the flagship's widths (the twin
    config with PQ 64 x 256, d = 16, 27 classes): every metric finite, the
    exact and lattice argmaxes >= 90% equal for both probes, 16 images; the
    path's launches are the valid forwards' exact narrow PQ body, one a val
    batch (the twin config's f32 backbone runs the plain attention, as the
    JAX twin's does, and training takes the plain PQ route)."""
    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.parity.crf_compare import run_crf_compare
    from equss_tpu_torch.parity.twin import make_twin_config

    cfg = make_twin_config(embed_dim=1024, num_pq=64, num_codebook=256, num_classes=27)
    reset_launch_counts()
    t0 = time.perf_counter()
    r = run_crf_compare(**CRF_COMPARE, device="cuda", cfg=cfg)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    results["launches"]["crf_compare"] = counts
    values = [v for row in r["metrics"].values() for v in row.values()]
    check(all(np.isfinite(v) for v in values), f"crf_compare: non-finite metric {r['metrics']}")
    check(min(r["agreement"].values()) >= 0.9, f"crf_compare: agreement {r['agreement']}")
    check(r["n_imgs"] == 16 and r["res"] == 224, f"crf_compare: {r['n_imgs']} images")
    check(counts == expected({"pq_assign": 1}, CRF_COMPARE["n_val"]),
          f"crf_compare: launches {counts}")
    emit({"phase": "crf_compare", **CRF_COMPARE, "model": "vit_small f32, PQ 64x256 exact",
          **r, "launches": counts, "seconds": seconds, "card": nvidia_smi()})


# ---------------------------------------------------------------- tools

# (tool, argv, the path's launches per unit, units): the tools that drive
# a main path count their launches under ``tools_<tool>``; flops launches
# nothing, and bench_pq_kernel holds the kernel against a library call,
# whose launches do not count
TOOL_RUNS = (
    ("flops", [], None, 0),
    ("profile_forward", ["--batch", "128", "--steps", "3"], SERVE_KERNELS, 5),
    ("bench_train_step", ["--windows", "1", "--iters", "5", "--route", "kernel"],
     FUSED_LN_KERNELS, 8),
    ("bench_serving", ["--batch", "8"], None, 0),
    ("bench_pq_kernel", ["--n", "100352"], None, 0),
    ("bench_pq_kernel", ["--n", "100352", "--exact"], None, 0),
    ("bench_pipeline", ["--n", "64", "--epochs", "1"], None, 0),
    ("e2e_demo", ["--epochs", "1", "--n-train", "16", "--n-val", "8"], None, 0),
)


def tool_checks(name: str, argv: list, out: dict, counts: dict) -> None:
    """The bars of each tool's own result."""
    if name == "flops":
        check(round(out["gflop_per_img_224"]["vit_small"]["total"], 2) == 46.69,
              f"tools flops: {out}")
    elif name == "bench_serving":
        for key in ("live", "symbolic_batch=auto", "symbolic_batch=off"):
            row = out[key]
            check(row["launches_per_request"] == expected(SERVE_KERNELS, 1),
                  f"tools bench_serving {key}: launches {row['launches_per_request']}")
            if key != "live":
                check(row["graph_ops"] == {"attention_qkv": 12, "pq_assign": 1}
                      and min(row["pixel_agreement_vs_live"].values()) >= 0.9999,
                      f"tools bench_serving {key}: ops {row['graph_ops']}, pixels "
                      f"{row['pixel_agreement_vs_live']}")
        check(out["symbolic_batch=off"]["input_shape"] == "(8, 224, 224, 3)"
              and out["symbolic_batch=auto"]["input_shape"] != "(8, 224, 224, 3)",
              "tools bench_serving: input shapes")
    elif name == "bench_pq_kernel":
        # against cdist's f32 distances: exact mode picks the same first
        # minimum but near ties, the fast mode's bf16 distances tie more
        need = 0.999 if "--exact" in argv else 0.99
        check(all(r["index_agreement"] >= need for r in out["rows"]),
              f"tools bench_pq_kernel {argv}: index agreement {out['rows']}")
    elif name == "bench_pipeline":
        check(all(v > 0 for v in out["img_per_sec"].values()) and counts["attention_qkv"] > 0,
              f"tools bench_pipeline: {out['img_per_sec']}, launches {counts}")
    elif name == "e2e_demo":
        check(out["e2e"] == "ok" and all(np.isfinite(v) for v in out["final"].values())
              and "crf_Cluster_mIoU" in out["final"]
              and counts["attention_qkv"] > 0 and counts["pq_assign"] > 0,
              f"tools e2e_demo: {out['final']}, launches {counts}")


def phase_tools(results: dict) -> None:
    """Each tool of ``equss_tpu_torch/tools`` once through its ``main``
    (``TOOL_RUNS``), its launches counted from 0, a line each with the
    result; ``bench_pipeline`` runs the native decode path where the
    library builds (it needs libjpeg's and libpng's headers)."""
    import importlib
    import traceback

    from equss_tpu_torch import launch_counts, reset_launch_counts
    from equss_tpu_torch.data import native_loader

    paths = "pil,native,pack" if native_loader.available() else "pil,pack"
    for name, argv, per_unit, units in TOOL_RUNS:
        if name == "bench_pipeline":
            argv = [*argv, "--paths", paths]
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            out = importlib.import_module(f"equss_tpu_torch.tools.{name}").main(argv)
        except Exception as e:  # noqa: BLE001 - a failing tool fails the run, and the next runs
            traceback.print_exc()
            check(False, f"tools {name} {argv}: {type(e).__name__}: {e}")
            continue
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        if name not in ("flops", "bench_pq_kernel"):
            results["launches"][f"tools_{name}"] = counts
        if per_unit is not None:
            check(counts == expected(per_unit, units), f"tools {name}: launches {counts}")
        tool_checks(name, argv, out, counts)
        emit({"phase": "tools", "tool": name, "argv": argv, "seconds": seconds,
              "launches": counts, "result": out})


KERNEL_SOURCES = {  # name: (source, the TPU kernel it replaces)
    "attention_qkv": ("equss_tpu_torch/csrc/attention_qkv.cu", "equss_tpu/ops/attention.py:198"),
    "attention": ("equss_tpu_torch/csrc/attention_qkv.cu", "equss_tpu/ops/attention.py:91"),
    "layernorm": ("equss_tpu_torch/csrc/layernorm.cu", "equss_tpu/ops/layernorm.py:74"),
    "add_layernorm": ("equss_tpu_torch/csrc/layernorm.cu", "equss_tpu/ops/layernorm.py:112"),
    "pq_assign": ("equss_tpu_torch/csrc/pq_assign.cu", "equss_tpu/ops/pq_pallas.py:443"),
    # the narrow exact body of the same wrapper (pq_exact_kernel): its
    # launches are the PQ launches of the preset's exact paths, the exact
    # sub-run's train and valid steps and the exact b = 8 serving
    "pq_assign_exact": ("equss_tpu_torch/csrc/pq_assign.cu", "equss_tpu/ops/pq_pallas.py:443"),
    # the wide bodies of the same wrapper: their launches are the PQ
    # launches of the VQ baseline's paths at d = 1024, fast
    # (pq_wide_fast_kernel) on the preset's bf16 assignments, exact
    # (pq_wide_exact_kernel) on the exact sub-run's; and of the variants'
    # valid steps, NewVQ's fast at 8 x 2048 x 64, UnSeg's exact at
    # 1 x 2048 x 384, the VAE's exact at 1 x 1024 x 256 (two levels) and
    # Contra's exact at 4 x 1024 x 128 and 16 x 1024 x 32
    "pq_assign_wide": ("equss_tpu_torch/csrc/pq_assign.cu", "equss_tpu/ops/pq_pallas.py:443"),
    "pq_assign_wide_exact": ("equss_tpu_torch/csrc/pq_assign.cu",
                             "equss_tpu/ops/pq_pallas.py:443"),
    # the shard entry (pq_assign_shard_launch) of the same kernel: its
    # launches are the tensor-parallel phase's, one per forward or step on
    # each rank's K shard
    "pq_assign_shard": ("equss_tpu_torch/csrc/pq_assign.cu", "equss_tpu/ops/pq_pallas.py:443"),
}


def pq_body_row(path: str) -> str:
    """The kernels line's PQ row whose body ``path``'s PQ launches run:
    the narrow exact body on the preset's exact paths and the CRF
    comparison's, the wide exact body on the exact VQ sub-run's, UnSeg's,
    the VAE's and Contra's, the wide fast body on the VQ baseline's and
    NewVQ's, the narrow fast body
    (``pq_assign``) on every other path (the preset's bf16 ones and
    ``pqgocls``'s)."""
    path = path.removeprefix("dist_variants_")      # the variants across ranks
    if path.startswith("tp_"):
        return "pq_assign_shard"
    if path.startswith(("pqgo_exact", "serve_exact", "crf_compare")):
        return "pq_assign_exact"
    if path.startswith(("vq_exact", "unseg", "vae", "contra")):
        return "pq_assign_wide_exact"
    if path.startswith(("vq_", "cli_vq", "new_vq")):
        return "pq_assign_wide"
    return "pq_assign"


def row_path(name: str, path: str) -> bool:
    """Whether the launches of ``path`` count for the kernels line's row
    ``name``: each PQ row takes the paths of its own body
    (``pq_body_row``), every other row all paths."""
    return pq_body_row(path) == name if name.startswith("pq_assign") else True


def timed(seconds: dict, fn, *args):
    """``fn(*args)``, its wall seconds added to ``seconds[fn's phase name]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        name = fn.__name__.removeprefix("phase_")
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


def main() -> int:
    t_start = time.perf_counter()
    seconds: dict = {}
    kind = timed(seconds, phase_device)
    timed(seconds, phase_build)
    results: dict = {"launches": {}}
    for phase in (phase_attention, phase_pq, phase_pq_wide, phase_layernorm,
                  phase_fused_attention):
        timed(seconds, phase, results)
    model, cfg = timed(seconds, phase_main, results)
    timed(seconds, phase_serve_fused_ln, model, cfg, results)
    timed(seconds, phase_profile, model)
    del model
    torch.cuda.empty_cache()
    for phase, args in ((phase_train, (results,)), (phase_train_reference, ()),
                        (phase_valid, (results,)), (phase_valid_reference, ()),
                        (phase_pqgo_exact, (results,)), (phase_fit, (results,)),
                        (phase_crf, ()), (phase_cli, (results,)), (phase_rest, (results,)),
                        (phase_custom_op_ab, (results,)), (phase_own_data, (results,)),
                        (phase_vq, (results,)), (phase_vq_reference, ()),
                        (phase_stego, (results,)), (phase_baselines, (results,)),
                        (phase_cli_baselines, (results,)), (phase_variants, (results,)),
                        (phase_new_vq_stage1, (results,)), (phase_variants_reference, ()),
                        (phase_distributed, (results,)), (phase_tensor_parallel, (results,)),
                        (phase_crf_compare, (results,)), (phase_tools, (results,))):
        timed(seconds, phase, *args)
    emit({"phase_seconds": seconds, "total_seconds": time.perf_counter() - t_start})

    # launches: every main-path run (serving, serving with fused_ln, both
    # train configurations, both valid configurations, the exact sub-run's
    # train and valid steps, fit, the three CLI runs, the variants' train
    # and valid steps, NewVQ's stage 1, the kNN job, the train job on
    # files, the exported artifact's requests, the custom-op side of the
    # A/B, the rest phase's paths, the CRF comparison's valid forwards and
    # the tools' paths), each counted from 0, each PQ launch under its
    # body's row;
    # ``attention`` has no caller on any path and is launched by its
    # kernel phase only
    by_path = results["launches"]
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        r = results[name]
        wrapper = ("pq_assign" if name.startswith("pq_assign") and name != "pq_assign_shard"
                   else name)
        paths = {p: c[wrapper] for p, c in by_path.items() if row_path(name, p)}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(paths.values()), "launches_by_path": paths,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "case": r["case"]})
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
