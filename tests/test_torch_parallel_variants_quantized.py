"""The quantizing ``models/variants.py`` families across ranks on the CPU:
``new`` (NewVQ, and its stage 1), ``spq``, ``vae``, ``info``, ``contra``
and ``ema``, two gloo ranks in subprocesses running this file, with the
harness and the bars of ``tests/test_torch_parallel_variants.py``.

vit_micro at 64^2, a global batch of 4 (2 rows a rank).  NewVQ, the VAE,
Info and Contra start from a k-means codebook of K = 16 made on the
first batch (``Trainer.data_init``), EMAModel from its k-means bank.

* Every family, 3 steps: the ranks bit-equal after every step and after
  ``data_init``, which is also bit-equal to the one-process run's; the
  one-process bars of ``ranks_match_one_process``; ``validate`` equal.
* NewVQ's stage 1 (K = 16, ``n_kmeans`` 4): the rows it selects from the
  global batch and the step's losses equal to the one-process run's.
* ``spq``, ``contra`` and ``ema`` from JAX's initial weights with JAX's
  draws fed (the view, the InfoNCE negatives, the split noise, the proxy
  indices): the ranks' summed gradients within 1e-4 of their scale of
  JAX's one-process step on the global batch, the loss terms within
  rtol 1e-5 and the new state within the bars of
  ``tests/test_torch_variants.py``.
"""
import os
import sys

import pytest
import torch

from equss_tpu_torch.parallel import mesh
from equss_tpu_torch.train.trainer import Trainer
from test_torch_parallel_variants import (family_cfg, jax_case, jax_case_matches,
                                          jax_case_on_ranks, launch, one_process,
                                          ranks_hold_the_same_state, ranks_match_one_process,
                                          rows_of, run_family, train_batches, val_batches)


def stage1_step(cfg, batch, rank=None):
    """One stage-1 forward and backward: the selected rows of the global
    batch and the step's metrics."""
    tr = Trainer(cfg, device="cpu")
    metrics, out = tr.forward_backward(batch if rank is None else rows_of(batch, rank))
    return {"selected": out["selected"],
            "metrics": {k: float(v.detach()) for k, v in metrics.items()}}


def _rank(rank, port, job_path, out_path):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    mesh.init_distributed(f"localhost:{port}", 2, rank, device="cpu")
    out = {"families": {name: run_family(cfg, job["train"], job["val"], rank)
                        for name, cfg in job["cfgs"].items()},
           "jax": {name: jax_case_on_ranks(case, rank) for name, case in job["jax"].items()},
           "stage1": stage1_step(job["stage1"], job["train"][0], rank)}
    torch.save(out, out_path)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


FAMILIES = ("new_vq_cocostuff27", "spq_cocostuff27", "vae_cocostuff27", "info_cocostuff27",
            "contra_cocostuff27", "ema_cocostuff27")
KMEANS_INIT = ("new_vq", "vae", "info", "contra")
JAX_CASES = ("spq", "contra", "ema")


def quantized_cfg(name):
    cfg = family_cfg(name)
    if name.startswith(KMEANS_INIT):
        vq = cfg["model"]["vq"]
        vq.update(need_initialized="kmeans", num_codebooks=[16] * len(vq["num_codebooks"]))
    return cfg


def stage1_cfg():
    cfg = family_cfg("new_vq_cocostuff27")
    cfg["model"].update(stage=1, n_kmeans=4)
    cfg["model"]["vq"]["num_codebooks"] = [16]
    cfg["eval"]["output_type"] = "feat"
    del cfg["loss"]["info_nce_weight"]       # stage 1 computes no InfoNCE
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, jax_want = {}, {}
    for key in JAX_CASES:
        cases[key], jax_want[key] = jax_case(f"{key}_cocostuff27")
    job = {"cfgs": {name: quantized_cfg(name) for name in FAMILIES},
           "train": train_batches(3, seed=1), "val": val_batches(1), "jax": cases,
           "stage1": stage1_cfg()}
    wait = launch(tmp_path_factory.mktemp("quantized"), job, os.path.abspath(__file__))
    ref = one_process(job)
    ref_stage1 = stage1_step(job["stage1"], job["train"][0])
    return {"ranks": wait(), "ref": ref, "ref_stage1": ref_stage1, "jax": jax_want,
            "job": job}


@pytest.mark.parametrize("name", FAMILIES)
def test_ranks_hold_the_same_state_after_every_step(runs, name):
    ranks_hold_the_same_state(runs, name)


@pytest.mark.parametrize("name", FAMILIES)
def test_two_ranks_match_one_process(runs, name):
    ranks_match_one_process(runs, name)


def test_data_init_runs_on_the_global_batch(runs):
    """Each k-means init set its codebook (or bank) from the global batch:
    every rank holds the one-process result."""
    for name in FAMILIES:
        if not name.startswith((*KMEANS_INIT, "ema")):
            continue
        got = runs["ranks"][1]["families"][name]["data_init"]
        want = runs["ref"][name]["data_init"]
        keys = [k for k in want if k.startswith("model.") and
                k.endswith(("codebook", "ema_weight", "queue", "centroid"))]
        assert keys, name
        for k in keys:
            assert torch.equal(got[k], want[k]), (name, k)


def test_new_vq_stage1_selects_the_one_process_rows(runs):
    got = [out["stage1"] for out in runs["ranks"]]
    want = runs["ref_stage1"]
    for g in got:
        assert torch.equal(g["selected"], want["selected"])
        assert set(g["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            rtol = 1e-4 if k.endswith("grad-norm") else 1e-5
            assert g["metrics"][k] == pytest.approx(v, rel=rtol, abs=1e-6), k


@pytest.mark.parametrize("key", JAX_CASES)
def test_two_ranks_match_jax_one_process(runs, key):
    jax_case_matches(runs, key)
