"""The models outside the pqgo family against the JAX package: the EMA
quantizer, STEGO, probe-only and supervised ``sl``.

* EMA quantizer ops: ``ema_codebook_update``, ``pq_forward`` in EMA
  training (indices, z_q, losses, usage telemetry, ``distance_prob`` and
  the new state) and ``ema_jsd_entropy`` against JAX's on the same numpy
  inputs, within 1e-6 relative (f32 sums in another order; ``vec_sum`` is
  an ``index_add_`` in the port and a HIGHEST-precision einsum in JAX).
  JAX's CPU backend cannot run the bf16 XLA path's bf16 x bf16 products,
  so these and the trainer comparisons take exact assignments; the card
  runs the bf16 configuration (``chip_smoke.py``'s vq phase).
* One train step each for ``stego``, ``probe``, ``sl`` and ``vq`` (EMA)
  on vit_micro, b = 2 at 64^2, dropout off, STEGO's samples fed to both
  sides: the JAX ``Trainer`` (built by its registry, a 2-device CPU mesh)
  with its initial state carried into the port by
  ``convert.train_state_from_jax`` (the round trip equal to the port's
  own ``train_state()``).  First-step gradients within 1e-4 of their
  largest magnitude, losses and metrics of two steps rtol 1e-5, weights
  after them within the bars of ``tests/test_torch_trainer.py``, the EMA
  state within rtol 1e-5, and ``validate`` before training with equal
  mIoU / Accuracy and losses within rtol 1e-5.
* A bit-exact mid-epoch resume of an EMA, a STEGO and a probe-only run;
  the CLI train job for ``configs/stego_cocostuff27.yaml`` and
  ``configs/vq_cocostuff27.yaml`` at vit_micro (checkpoints, final and
  final CRF evaluations, an eval-only resume reproducing them); the
  crop, knn and export jobs for the stego, cluster_baseline, sl and vq
  configs; the supervised CRF evaluation without a cluster probe; a STEGO
  export round trip against the live predictor and the JAX package's
  ``build_predict_fn``; and ``chip_smoke.py``'s dict configs equal to the
  YAML files.
"""
import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equss_tpu import serve as jserve
from equss_tpu.ops import quantizer as jq
from equss_tpu.parallel.mesh import make_mesh
from equss_tpu.train.trainer import Trainer as JTrainer
from equss_tpu_torch import cli, serve
from equss_tpu_torch.convert import params_from_jax, probes_from_flax, train_state_from_jax
from equss_tpu_torch.convert import _trainable_from_flax
from equss_tpu_torch.data.synthetic import synthetic_batches
from equss_tpu_torch.ops import quantizer as tq
from equss_tpu_torch.train.trainer import Trainer
from test_torch_checkpoint import _assert_states_equal, _flat
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_trainer import LR_MODEL, _batches, micro_cfg
from test_torch_valid import _Recorder, _val_batches


def _close(got, want, rtol=1e-6):
    """Within ``rtol`` of each value, or of the array's scale for values
    near zero."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ EMA ops

def _ema_cfgs(**kw):
    base = dict(num_pq=2, num_codebook=128, embed_dim=64, vq_type="ema", normalize="none",
                eps=1e-6, decay=0.99)
    base.update(kw)
    return jq.PQConfig(**base), tq.PQConfig(**base)


def test_ema_codebook_update_matches_jax():
    cfg_j, cfg_t = _ema_cfgs()
    rng = np.random.RandomState(0)
    M, K, d = 2, 128, 32
    state = {"ema_count": rng.rand(M, K).astype(np.float32),
             "ema_weight_avg": rng.randn(M, K, d).astype(np.float32),
             "ema_weight": rng.randn(M, K, d).astype(np.float32),
             "vq_count": rng.rand(M, K).astype(np.float32)}
    count = rng.randint(0, 5, (M, K)).astype(np.float32)
    vec_sum = rng.randn(M, K, d).astype(np.float32)
    want = jq.ema_codebook_update({k: jnp.asarray(v) for k, v in state.items()},
                                  jnp.asarray(count), jnp.asarray(vec_sum), cfg_j)
    got = tq.ema_codebook_update({k: torch.from_numpy(v) for k, v in state.items()},
                                 torch.from_numpy(count), torch.from_numpy(vec_sum), cfg_t)
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k])


@pytest.mark.parametrize("normalize,jsd_ts", [("none", 1.0), ("l2", 1.0), ("none", 0.01)])
def test_pq_forward_ema_training_matches_jax(normalize, jsd_ts):
    """``jsd_ts`` 1.0 leaves the distance softmax near uniform, 0.01 makes
    it peaked.  The softmax multiplies the distances' f32 rounding (sums in
    another order) by 1 / jsd_ts, so the peaked case takes the unnormalised
    vectors, whose distances are small enough for the 1e-6 bar (l2's reach
    4 and would move the probabilities by ~1e-5 at 0.01).  The JSD is a
    difference of sums of terms the size of the entropy, so it is held to
    1e-6 of that size."""
    cfg_j, cfg_t = _ema_cfgs(normalize=normalize, jsd_ts=jsd_ts)
    params, state = jq.pq_init(jax.random.PRNGKey(2), cfg_j)
    rng = np.random.RandomState(1)
    z = (0.05 * rng.randn(2, 6, 5, 64)).astype(np.float32)
    zq_j, idx_j, aux_j, st_j = jq.pq_forward(jnp.asarray(z), params, state, cfg_j,
                                             training=True)
    to_t = lambda tree: {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}  # noqa: E731
    zq_t, idx_t, aux_t, st_t = tq.pq_forward(torch.from_numpy(z), to_t(params), to_t(state),
                                             cfg_t, training=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(zq_t.detach().numpy(), np.asarray(zq_j), rtol=0, atol=1e-6)
    assert aux_t["distance_prob"].shape == (2, 6, 5, 2, 128)
    _close(aux_t["distance_prob"].detach().numpy(), aux_j["distance_prob"])
    for k in ("vq-loss", "codebook-sum", "codebook-usage", "current-p10", "current-p50",
              "current-p90"):
        _close(float(aux_t[k]), float(aux_j[k]), 1e-6 if k != "vq-loss" else 1e-5)
    assert set(st_t) == set(st_j) == {"vq_count", "ema_weight", "ema_weight_avg", "ema_count"}
    for k in st_j:
        _close(st_t[k].numpy(), st_j[k])
    # the telemetry the model computes from it, on the pixels' halves
    flat_t = aux_t["distance_prob"].reshape(-1, 2, 128)
    flat_j = aux_j["distance_prob"].reshape(-1, 2, 128)
    jsd_t, ent_t = tq.ema_jsd_entropy(flat_t[:30], flat_t[30:])
    jsd_j, ent_j = jq.ema_jsd_entropy(flat_j[:30], flat_j[30:])
    _close(float(ent_t), float(ent_j))
    assert abs(float(jsd_t) - float(jsd_j)) <= 1e-6 * abs(float(ent_j))


# ----------------------------------------------- train steps vs JAX

def micro(name):
    """vit_micro versions of the baselines' configs: ``stego``, ``sl``
    (supervised, no loss weights), ``probe`` and ``vq`` (EMA, M = 1,
    K = 128, d = 64, exact assignments)."""
    cfg = micro_cfg(bf16=False)
    if name == "vq":
        cfg["model"]["vq"] = {"vq_type": "ema", "num_codebooks": [128], "embed_dims": [64],
                              "beta": 0.25, "book": 1.0, "normalize": "none",
                              "need_initialized": "none", "num_pq": [1], "decay": 0.99,
                              "eps": 1.0e-6, "assign_precision": "exact"}
        return cfg
    del cfg["model"]["vq"]
    cfg["model"]["name"] = name
    cfg["eval"]["output_type"] = "feat"
    if name in ("stego", "sl"):
        cfg["model"]["pretrained"]["dim"] = 12
    if name == "stego":
        del cfg["loss"]["vq_weight"]
    else:
        cfg["loss"] = {}
    if name == "sl":
        cfg["train"]["supervised"] = True
    return cfg


def _pair(name):
    cfg = micro(name)
    jtr = JTrainer(cfg, mesh=make_mesh(2))
    ts = jtr.init_state(jax.random.PRNGKey(0), img_hw=(64, 64))
    state = train_state_from_jax(jax.device_get(ts), cfg)
    tr = Trainer(cfg, device="cpu")
    tr.load_train_state(copy.deepcopy(state))
    return cfg, jtr, ts, tr, state


def _jax_grads(jtr, ts, batch):
    b = jtr._normalize_batch({k: jnp.asarray(v) for k, v in jtr._host_trim(batch).items()})
    override = (b["stego_coords1"], b["stego_coords2"], b["stego_perms"])

    def loss_fn(trainable):
        params = dict(ts["params"], **trainable["model"])
        out, _ = jtr.model.apply(params, ts["model_state"], b["img"], img_pos=b["img_pos"],
                                 training=True, rng=jax.random.PRNGKey(1),
                                 stego_override=override)
        ev = jtr.evaluator.apply({"params": trainable["probes"]}, jtr._select_out(out),
                                 b["label"])
        return jtr._model_loss(out["aux"]) + ev["linear_loss"] + ev.get("cluster_loss", 0.0)

    trainable = {"model": jtr._trainable(ts["params"]), "probes": ts["probe_params"]}
    grads = jax.device_get(jax.grad(loss_fn)(trainable))
    out = _trainable_from_flax(grads["model"])
    out.update({f"probes.{k}": v for k, v in probes_from_flax(grads["probes"]).items()})
    return out


METRICS = ("loss", "model-loss", "linear-loss", "cluster-loss", "stego-loss", "vq-loss",
           "codebook-usage", "codebook-sum", "jsd", "entropy", "grad-norm", "skipped")


@pytest.mark.parametrize("name", ["stego", "probe", "sl", "vq"])
def test_train_steps_and_validate_match_jax(name):
    cfg, jtr, ts, tr, state = _pair(name)
    mine = tr.train_state()
    for k, v in _flat(state).items():           # the converted state, loaded as it was
        assert torch.equal(_flat(mine)[k], v), k
    assert set(_flat(mine)) == set(_flat(state)) | {"generator"}
    if name == "probe":
        assert tr.model_params == [] and mine["opt"]["model"]["state"] == {}
    if name == "sl":
        assert tr.evaluator.cluster_probe is None and "cluster_probe" not in ts["probe_params"]

    val = _val_batches(2, seed=3)
    val_j, val_t = jtr.validate(ts, val), tr.validate(val)
    assert set(val_t) == set(val_j)
    for k, v in val_j.items():
        if k.endswith(("mIoU", "Accuracy")):
            assert val_t[k] == pytest.approx(v, abs=1e-6), k
        else:
            assert val_t[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k

    batches = _batches(2, seed=2)
    want = _jax_grads(jtr, ts, batches[0])
    tr.forward_backward(batches[0])
    got = {n: p.grad for n, p in [*tr.model_params,
                                  *((f"probes.{n}", p) for n, p in tr.probe_params)]}
    assert set(got) == set(want)
    for k in got:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)

    for batch in batches:
        ts, m_j = jtr.train_step(ts, batch)
        m_t = tr.train_step(batch)
        assert {k for k in METRICS if k in m_j} <= set(m_t)
        for k in METRICS:
            if k in m_j:
                assert m_t[k] == pytest.approx(float(m_j[k]), rel=1e-5, abs=1e-7), k
    host = jax.device_get(ts)
    sd = params_from_jax(host["params"], host["model_state"], tr.model.cfg,
                         probe_params=host["probe_params"])
    mine = tr.state_dict()
    assert set(sd) == set(mine)
    for k, v in sd.items():
        if k.startswith("backbone."):
            assert torch.equal(mine[k], v), k
        elif k.startswith("pq_state."):
            _close(mine[k].numpy(), v.numpy(), 1e-5)
        else:
            diff = (mine[k] - v).abs()
            lr = 3.0e-3 if k.startswith("probes.") else LR_MODEL
            assert diff.max() <= 2 * lr + 1e-6, k
            assert (diff > 1e-6).float().mean() <= 0.01, k


# --------------------------------------------------- runs and resume

@pytest.mark.parametrize("name", ["vq", "stego", "probe"])
def test_mid_epoch_resume_is_bit_exact(name):
    """``fit`` with dropout and STEGO's own draws for 2 epochs of 4 steps;
    a fresh trainer restoring the step-2 checkpoint ends equal (the EMA
    buffers of ``vq`` included; ``stego`` and ``probe`` hold no model
    state, ``probe`` no model optimizer moments) with equal logs after
    step 2."""
    cfg = micro(name)
    cfg["model"]["pretrained"]["dropout"] = True
    cfg["train"].update(max_epochs=2, iter_per_epoch=4, print_interval_iters=1,
                        valid_interval_iters=2)

    def epoch_batches(epoch):
        return synthetic_batches(30 + epoch, 4, batch_size=2, res=64, num_classes=4)

    val = _val_batches(1)
    full, rec_full = Trainer(cfg, device="cpu"), _Recorder()
    saved = {}

    class Keep:
        def save(self, step, state, metadata=None):
            saved[step] = copy.deepcopy(state)

    full.fit(epoch_batches, lambda: val, logger=rec_full, checkpointer=Keep())
    assert 2 in saved
    assert ("pq_state.ema_weight" in saved[2]["model"]) == (name == "vq")
    resumed, rec_res = Trainer(cfg, device="cpu", seed=99), _Recorder()
    resumed.fit(epoch_batches, lambda: val, logger=rec_res, state=saved[2])
    strip = lambda recs: [(s, {k: v for k, v in m.items() if k != "iter_time"})  # noqa: E731
                          for s, m in recs]
    assert strip(rec_res.records) == [r for r in strip(rec_full.records) if r[0] > 2]
    assert any("jsd" in m for _, m in rec_res.records) == (name == "vq")
    _assert_states_equal(resumed.train_state(), full.train_state())


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _cli(tmp_path, config, *extra):
    before = set(glob.glob(str(tmp_path / "runs" / "*")))
    result = cli.main(["--config", config, "--debug", f"save_dir={tmp_path / 'runs'}",
                       "device=cpu", "model.pretrained.model_type=vit_micro",
                       "model.pretrained.dim=12", "dataset.synthetic=true",
                       "dataset.synthetic_batches=4", "dataloader.train.batch_size=2",
                       "dataloader.val.batch_size=2", "dataset.train.res=32",
                       "dataset.val.res=32", "train.max_epochs=1",
                       "train.print_interval_iters=1", "train.valid_interval_iters=2",
                       "eval.crf={max_iter: 1, block: 256}", *extra])
    (run_dir,) = set(glob.glob(str(tmp_path / "runs" / "*"))) - before
    return result, run_dir


@pytest.mark.parametrize("config", ["configs/stego_cocostuff27.yaml",
                                    "configs/vq_cocostuff27.yaml"])
def test_cli_train_job_runs_the_baseline(tmp_path, config):
    """The train job of a STEGO and of the EMA VQ config as it is (the
    VQ at its full quantizer, M = 1, K = 256, d = 1024), on vit_micro:
    four logged steps, checkpoints on each new best, the final and final
    CRF evaluations at the best step, and an eval-only resume that
    reproduces them."""
    result, run_dir = _cli(tmp_path, config)
    records = _records(run_dir)
    steps = [r for r in records if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["skipped"] == 0.0 for r in steps)
    if "vq" in config:
        assert all(np.isfinite(r[k]) for r in steps for k in ("jsd", "entropy", "vq-loss"))
    (final,) = [r for r in records if "final_Cluster_mIoU" in r]
    (crf,) = [r for r in records if "final_crf_Cluster_mIoU" in r]
    assert final["step"] == crf["step"] == result["best"]["iter"]
    ckpt = os.path.join(run_dir, "ckpt")
    evald, _ = _cli(tmp_path, config, f"resume.checkpoint={ckpt}", "resume.mode=eval")
    assert abs(evald["best"]["Cluster_mIoU"] - final["final_Cluster_mIoU"]) < 1e-6
    assert abs(evald["best"]["crf_Cluster_mIoU"] - crf["final_crf_Cluster_mIoU"]) < 1e-6


@pytest.mark.parametrize("config", ["stego_cocostuff27", "cluster_baseline", "sl_cocostuff27",
                                    "vq_cocostuff27"])
def test_knn_and_export_jobs_build_every_registry_model(tmp_path, config):
    """The crop, knn and export jobs of each baseline's config as it is
    but for vit_micro at 16^2 on a miniature COCO-Stuff corpus: every crop
    its own first neighbour, and the exported predictor's outputs (no
    cluster predictions for the supervised model)."""
    from test_torch_data import write_coco

    root = write_coco(tmp_path / "coco", n_train=6, n_val=1)
    args = ["--config", f"configs/{config}.yaml", "--debug", "device=cpu", f"data_dir={root}",
            "model.pretrained.model_type=vit_micro",
            "dataset.train={model_type: vit_micro, crop_type: five, crop_ratio: 0.5, res: 16}",
            "dataset.train.data_dir=${data_dir}", "dataset.train.dataset_name=${dataset_name}",
            "dataset.val={model_type: vit_micro, crop_type: null, res: 16}"]
    cli.main(["crop", *args])
    nns = np.load(cli.main(["knn", *args]))["nns"]
    np.testing.assert_array_equal(nns[:, 0], np.arange(30))
    path = cli.main(["export", *args, f"export.path={tmp_path / 'model.pt2'}",
                     "export.symbolic_batch=off"])
    out = serve.load_predictor(path)(np.random.RandomState(0).rand(1, 16, 16, 3))
    want = {"linear_preds"} if config == "sl_cocostuff27" else {"cluster_preds", "linear_preds"}
    assert set(out) == want and all(tuple(v.shape) == (1, 16, 16) for v in out.values())


def test_supervised_crf_evaluation_repeats_the_linear_probe():
    """``sl`` has no cluster probe: the CRF step refines the linear probe
    alone and ``validate_crf`` reports it under the Cluster keys too, as
    ``validate`` does (the JAX CRF step reads a cluster probe it lacks)."""
    cfg = micro("sl")
    cfg["eval"]["crf"] = {"max_iter": 1, "block": 256}
    tr = Trainer(cfg, device="cpu")
    batches = _val_batches(1, seed=5)
    res = tr.valid_crf_step(batches[0])
    assert set(res) == {"linear_conf", "linear_preds"}
    out = tr.validate_crf(batches)
    assert out["Cluster_mIoU"] == out["Linear_mIoU"]
    assert out["Cluster_Accuracy"] == out["Linear_Accuracy"]


def test_stego_export_round_trip_and_jax_predictor(tmp_path):
    cfg = micro("stego")
    jtr = JTrainer(cfg, mesh=make_mesh(1))
    ts = jax.device_get(jtr.init_state(jax.random.PRNGKey(0), img_hw=(16, 16)))
    tr = Trainer(cfg, device="cpu")
    tr.load_state_dict(params_from_jax(ts["params"], ts["model_state"], tr.model.cfg,
                                       probe_params=ts["probe_params"]))
    img = np.random.RandomState(4).rand(3, 16, 16, 3).astype(np.float32)
    want = jax.jit(jserve.build_predict_fn(jtr, ts))(img)
    live = serve.build_predict_fn(tr)
    got = live(torch.from_numpy(img))
    assert set(got) == set(want) == {"cluster_preds", "linear_preds"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    path = serve.save_predictor(serve.export_predictor(tr, (16, 16)),
                                str(tmp_path / "stego.pt2"))
    predict = serve.load_predictor(path)
    for b in (1, 3):
        x = torch.from_numpy(img[:b])
        out, ref = predict(x), live(x)
        assert set(out) == set(ref)
        for k in ref:
            assert torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("name", ["vq_cocostuff27", "stego_cocostuff27", "stego_potsdam",
                                  "stego_pascal", "cluster_baseline", "sl_cocostuff27",
                                  "pqgo_cls_cocostuff27", "cluster_margin_cocostuff27",
                                  "cluster_swav_cocostuff27", "res_cocostuff27",
                                  "unseg_cocostuff27", "new_vq_cocostuff27", "spq_cocostuff27",
                                  "vae_cocostuff27", "info_cocostuff27", "contra_cocostuff27",
                                  "ema_cocostuff27"])
def test_chip_smoke_presets_are_the_yaml_configs(name):
    import chip_smoke
    from equss_tpu_torch.core.config import load_config

    assert chip_smoke.preset(name) == load_config(f"configs/{name}.yaml")
    assert chip_smoke.PQGO_COCOSTUFF27 == load_config("configs/pqgo_cocostuff27.yaml")


# the PQ rows of chip_smoke.py's kernels line and the paths whose PQ
# launches each takes (the path names chip_smoke's phases count under)
_PQ_ROW_PATHS = {
    "pq_assign": ["serve", "serve_fused_ln", "train_kernel", "train_stock", "valid_kernel",
                  "valid_stock", "fit", "cli_train", "cli_eval", "cli_resume", "knn",
                  "train_files", "export_requests", "custom_op_ab",
                  "pqgo_cls_cocostuff27_train", "pqgo_cls_cocostuff27_valid",
                  "stego_cocostuff27_valid", "cli_stego", "export_stego",
                  "res_cocostuff27_valid", "spq_cocostuff27_valid", "info_cocostuff27_valid",
                  "ema_cocostuff27_valid",
                  # the rest phase: PQ launches only in the visualised valid
                  # steps and the profiled CLI run (narrow fast), none in
                  # the option steps (the plain route)
                  "rest_visualize", "rest_cli_profile", "rest_cache", "rest_backbone",
                  "rest_pqgo_restart_dropout", "rest_pqgo_weighted_sum",
                  "rest_ema_restart_dropout"],
    "pq_assign_exact": ["serve_exact", "pqgo_exact_train", "pqgo_exact_valid"],
    "pq_assign_wide": ["vq_train", "vq_valid", "vq_serve", "cli_vq",
                       "new_vq_cocostuff27_train", "new_vq_cocostuff27_valid",
                       "new_vq_stage1_train"],
    "pq_assign_wide_exact": ["vq_exact_valid", "vq_exact_serve", "unseg_cocostuff27_train",
                             "unseg_cocostuff27_valid", "vae_cocostuff27_train",
                             "vae_cocostuff27_valid", "contra_cocostuff27_train",
                             "contra_cocostuff27_valid"],
    "pq_assign_shard": ["tp_1x2_quantizer_serve", "tp_2x2_quantizer_backbone_train"],
}


def test_chip_smoke_kernels_line_counts_each_pq_body_once():
    """``row_path``: each path's PQ launches count under one PQ row, its
    body's (the narrow fast row no longer sums the wide and exact
    launches); the other kernels' rows take every path."""
    import chip_smoke

    paths = [p for ps in _PQ_ROW_PATHS.values() for p in ps]
    for row, mine in _PQ_ROW_PATHS.items():
        assert [p for p in paths if chip_smoke.row_path(row, p)] == mine, row
    pq_rows = [r for r in chip_smoke.KERNEL_SOURCES if r.startswith("pq_assign")]
    assert sorted(pq_rows) == sorted(_PQ_ROW_PATHS)
    for p in paths:
        assert sum(chip_smoke.row_path(r, p) for r in pq_rows) == 1, p
        assert all(chip_smoke.row_path(r, p) for r in chip_smoke.KERNEL_SOURCES
                   if not r.startswith("pq_assign")), p


def test_chip_smoke_routes_the_vae_and_contra_valid_paths_to_the_wide_exact_body():
    """The VAE's and Contra's valid steps launch the PQ kernel twice, on the
    wide exact body (``pq_body_row``): the VAE's two levels at 1 x 1024 x
    256 (the top at a quarter of the pixels), Contra's at 4 x 1024 x 128
    and 16 x 1024 x 32; the shapes are those of the configs' quantizers,
    outside the narrow exact body's domain; Info and EMAModel launch none,
    and every variant of the script is a config of the registry."""
    import chip_smoke
    from equss_tpu_torch.core.config import load_config
    from equss_tpu_torch.models.registry import build_model
    from equss_tpu_torch.ops.pq_assign import kernel_body

    for name in ("vae_cocostuff27", "contra_cocostuff27"):
        for what in ("train", "valid"):
            assert chip_smoke.pq_body_row(f"{name}_{what}") == "pq_assign_wide_exact"
        launches, wide = chip_smoke.pq_valid(name)
        assert launches == 2 and len(wide) == 2
        cfg = load_config(f"configs/{name}.yaml")
        cfg["model"]["pretrained"]["model_type"] = "vit_micro"
        model = build_model(cfg, device="cpu")
        assert [(c.num_pq, c.num_codebook, c.sub_dim) for c in model.pq_cfgs] == \
            [shape for shape, _, _ in wide]
        for (M, K, d), exact, _ in wide:
            assert exact and kernel_body(d, K, exact) == "wide"
    assert [rows for *_, rows in chip_smoke.pq_valid("vae_cocostuff27")[1]] == [400, 1600]
    for name in ("info_cocostuff27", "ema_cocostuff27"):
        assert chip_smoke.pq_valid(name) == (0, None)
    assert {v[0] for v in chip_smoke.VARIANTS} >= {
        "vae_cocostuff27", "info_cocostuff27", "contra_cocostuff27", "ema_cocostuff27"}
    assert chip_smoke.wide_launch_groups([("pq_wide_exact_prep_kernel", 1.0),
                                          ("pq_wide_exact_kernel<0, false>", 2.0),
                                          ("pq_wide_exact_gather_kernel", 0.5),
                                          ("pq_wide_exact_kernel<1, true>", 4.0)]) == [3.5, 4.0]


def test_chip_smoke_holds_each_wide_launch_beside_its_isolated_row_at_the_same_n():
    """Every wide launch of a variant's valid step (``PQ_VALID`` at the
    valid batch of ``VARIANTS``) has a row of the ``pq_wide`` phase at its
    quantizer shape and its own n (``WIDE_PQ``), and
    ``wide_launches_in_path`` sets each launch of a profile beside the
    isolated row of that shape, mode and n: one launch or two per step."""
    import chip_smoke

    measured = {((M, K, d), n) for _, M, K, d, _, ns in chip_smoke.WIDE_PQ for n in ns}
    for name, _, vbs, _, _ in chip_smoke.VARIANTS:
        for shape, _, rows in chip_smoke.pq_valid(name)[1] or ():
            assert (shape, vbs * rows) in measured, (name, shape, vbs * rows)
    iso = {((1, 1024, 256), True, 3200): {"ms": 0.5, "launch": {"fused": False}},
           ((1, 1024, 256), True, 12800): {"ms": 1.0, "launch": {"fused": True}}}
    seq = [("pq_wide_exact_prep_kernel", 0.1), ("pq_wide_exact_kernel<0, false>", 0.4),
           ("pq_wide_exact_gather_kernel", 0.1), ("pq_wide_exact_kernel<1, true>", 2.0)]
    prof = {"calls": 2, "sequence": seq * 2,
            "picked": [{"name": "pq_wide_exact_kernel<1, true>", "ms": 4.0}]}
    out = chip_smoke.wide_launches_in_path(prof, chip_smoke.pq_valid("vae")[1], 8, "vae",
                                           iso)["wide_launches"]
    assert [(r["n"], r["fused"]) for r in out] == [(3200, False), (12800, True)]
    assert [r["pq_wide_ms_per_launch"] for r in out] == pytest.approx([0.6, 2.0])
    assert [r["in_path_over_isolated"] for r in out] == pytest.approx([1.2, 2.0])
    one = {"calls": 2, "sequence": seq[3:] * 2, "picked": prof["picked"]}
    (row,) = chip_smoke.wide_launches_in_path(one, [((1, 1024, 256), True, 1600)], 8, "one",
                                              iso)["wide_launches"]
    assert row["pq_wide_ms_per_launch"] == pytest.approx(2.0)
    assert row["pq_wide_share_of_bound"] == pytest.approx(row["pq_wide_bound_ms"] / 2.0)
    assert not chip_smoke.FAILURES
