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
The configurations of 17-23 are ``preset(name)``: the preset with the
changes of ``PRESET_CHANGES``, which the tests hold against ``configs/``.
In the kernels line each PQ row counts the launches of its own body's
paths (``row_path``): the narrow fast row the preset's bf16 paths, the
narrow exact row the preset's exact ones, the wide fast row the VQ
baseline's and NewVQ's, the wide exact row the exact VQ sub-run's and
UnSeg's.

Then the ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
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


# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12        # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12

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


def device_profile(fn, calls: int, pick=(), sequence: Optional[str] = None) -> dict:
    """Device time by kernel and the device's busy share over ``calls``
    calls of ``fn`` (after two unprofiled ones), torch.profiler; the top
    kernels, and under ``picked`` every kernel whose name holds one of the
    strings ``pick``; with ``sequence``, under ``sequence`` the (name, ms)
    of every kernel whose name holds it, in the order they ran."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the kernels themselves (device-side events), not the ops that
    # launched them, which report the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:14]
    row = lambda e: {"name": e.key[:80], "ms": e.self_device_time_total / 1e3,  # noqa: E731
                     "calls": e.count, "ms_per_call": e.self_device_time_total / 1e3 / e.count}
    out = {"calls": calls, "wall_ms": 1e3 * wall, "device_ms": total / 1e3,
           "device_busy_share": total / 1e3 / (1e3 * wall),
           "kernel_launches": sum(e.count for e in events),
           "top": [row(e) for e in top],
           "picked": [row(e) for e in events if any(s in e.key for s in pick)]}
    if sequence is not None:
        ran = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and sequence in e.name),
                     key=lambda e: e.time_range.start)
        out["sequence"] = [(e.name[:80], e.time_range.elapsed_us() / 1e3) for e in ran]
    return out


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
    1024, PQ 64 x 256 with l2 normalisation."""
    from equss_tpu_torch import EQUSSConfig, PQConfig

    return EQUSSConfig(
        model_type="vit_small", patch_size=8, hidden_dim=1024,
        backbone_dtype=torch.bfloat16, attn_bf16=True,
        pq=PQConfig(num_pq=64, num_codebook=256, embed_dim=1024,
                    vq_type="param", normalize="l2", assign_precision=precision))


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
    serving forwards at b = 1 and at b = 128."""
    from equss_tpu_torch.data.transforms import normalize_images

    for batch in (1, 128):
        img = normalize_images(requests(batch, 1, seed=3)[0].to("cuda"))
        emit({"phase": "profile", "what": "serve", "batch": batch, "forwards": 2,
              **device_profile(lambda: model(img), 2, pick=KERNEL_PICK)})


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


def train_model(kind: str, device: str = "cuda", dropout: bool = True, **train):
    """(config, Trainer) of one train configuration, weights from seed 0;
    ``train`` overrides keys of its ``train`` section."""
    from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig
    from equss_tpu_torch.train.trainer import Trainer

    cfg = train_config(kind)
    cfg["model"]["pretrained"]["dropout"] = dropout
    cfg["train"].update(train)
    mcfg = dataclasses.replace(EQUSSConfig.from_config(cfg), fused_ln=kind == "kernel")
    return cfg, Trainer(cfg, device=device, model=EQUSS(mcfg, device=device, seed=0))


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
    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.ops.attention import attention_qkv
    from equss_tpu_torch.ops.pq_assign import normalize_vectors, pq_assign
    from equss_tpu_torch.tools import ctypes_ab

    model = EQUSS(main_config("bf16"), device="cuda", seed=0)
    ctypes_fns = (ctypes_ab.attention_qkv_ctypes, ctypes_ab.pq_assign_ctypes)
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
                before_t = [f.launches for f in ctypes_fns]
                if name == "ctypes":
                    with ctypes_ab.ctypes_wrappers():
                        timed(3)
                        t, outs[name] = timed(20)
                else:
                    timed(3)
                    t, outs[name] = timed(20)
                times[name] += t
                made_c = {k: v - before_c[k] for k, v in launch_counts().items()}
                made_t = [f.launches - b for f, b in zip(ctypes_fns, before_t)]
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
}


def pq_body_row(path: str) -> str:
    """The kernels line's PQ row whose body ``path``'s PQ launches run:
    the narrow exact body on the preset's exact paths, the wide exact body
    on the exact VQ sub-run's, UnSeg's, the VAE's and Contra's, the wide
    fast body on the VQ baseline's and NewVQ's, the narrow fast body
    (``pq_assign``) on every other path (the preset's bf16 ones and
    ``pqgocls``'s)."""
    if path.startswith(("pqgo_exact", "serve_exact")):
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


def main() -> int:
    kind = phase_device()
    phase_build()
    results: dict = {"launches": {}}
    phase_attention(results)
    phase_pq(results)
    phase_pq_wide(results)
    phase_layernorm(results)
    phase_fused_attention(results)
    model, cfg = phase_main(results)
    phase_serve_fused_ln(model, cfg, results)
    phase_profile(model)
    del model
    torch.cuda.empty_cache()
    phase_train(results)
    phase_train_reference()
    phase_valid(results)
    phase_valid_reference()
    phase_pqgo_exact(results)
    phase_fit(results)
    phase_crf()
    phase_cli(results)
    phase_custom_op_ab(results)
    phase_own_data(results)
    phase_vq(results)
    phase_vq_reference()
    phase_stego(results)
    phase_baselines(results)
    phase_cli_baselines(results)
    phase_variants(results)
    phase_new_vq_stage1(results)
    phase_variants_reference()

    # launches: every main-path run (serving, serving with fused_ln, both
    # train configurations, both valid configurations, the exact sub-run's
    # train and valid steps, fit, the three CLI runs, the variants' train
    # and valid steps, NewVQ's stage 1, the kNN job, the train job on
    # files, the exported artifact's requests and the custom-op side of the
    # A/B), each counted from 0, each PQ launch under its body's row;
    # ``attention`` has no caller on any path and is launched by its
    # kernel phase only
    by_path = results["launches"]
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        r = results[name]
        wrapper = "pq_assign" if name.startswith("pq_assign") else name
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
