"""The port's metrics, valid step, ``validate`` and ``fit`` vs the JAX
package.

* ``confusion_update`` and ``UnSegMetrics`` (``compute``, ``assignments``,
  ``histogram``, ``map_clusters``): equal to the JAX ones, bit for bit, on
  random predictions and labels that include -1 and values past
  num_classes, with and without extra classes.
* The valid step on vit_micro, f32, exact PQ, b = 2 at 64^2, for both
  ``probe_res`` values: the JAX ``Trainer`` on a 2-device CPU mesh (Pallas
  interpreted), its state carried over with ``params_from_jax``.  Both
  confusion matrices and both predictions equal, losses within rtol 1e-5
  (f32 sums in another order).
* ``validate`` over 2 batches: the same keys, the four mIoU / Accuracy
  values equal (equal confusion matrices), losses rtol 1e-5; without a
  cluster probe the Cluster keys repeat the Linear ones, and
  ``visualize_to`` writes nothing, as in JAX (the PNGs themselves:
  tests/test_torch_visualize.py).
* ``fit``: one epoch of 2 steps, a log every step and a validation after
  step 2 and at the epoch's end, against the JAX ``fit``; a run of
  non-finite steps raises after ``nonfinite_patience`` samples.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from equss_tpu.eval import metrics as jmetrics
from equss_tpu.parallel.mesh import make_mesh
from equss_tpu.train.trainer import Trainer as JTrainer
from equss_tpu_torch.convert import params_from_jax
from equss_tpu_torch.data.synthetic import synthetic_batches
from equss_tpu_torch.eval.metrics import UnSegMetrics, confusion_update
from equss_tpu_torch.train.trainer import Trainer
from test_torch_trainer import _batches, micro_cfg

NUM_CLASSES = 4


def _random_preds_labels(rng, shape, num_classes, extra):
    """Predictions in [-1, num_classes + extra + 1), labels in [-1,
    num_classes + 1): both include values the mask drops."""
    preds = rng.randint(-1, num_classes + extra + 1, shape).astype(np.int32)
    label = rng.randint(-1, num_classes + 1, shape).astype(np.int32)
    return preds, label


@pytest.mark.parametrize("extra", [0, 3])
def test_confusion_update_equals_jax(extra):
    rng = np.random.RandomState(extra)
    preds, label = _random_preds_labels(rng, (3, 40, 50), 27, extra)
    got = confusion_update(torch.from_numpy(preds), torch.from_numpy(label), 27, extra)
    want = np.asarray(jmetrics.confusion_update(preds, label, 27, extra))
    assert got.dtype == torch.int64 and got.shape == (27 + extra, 27)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("extra", [0, 3])
def test_unseg_metrics_equal_jax(extra):
    """Labels of a few classes follow the predictions so the matching is
    not trivial; two updates accumulate."""
    rng = np.random.RandomState(10 + extra)
    mine = UnSegMetrics(6, extra, compute_hungarian=True)
    ref = jmetrics.UnSegMetrics(6, extra, compute_hungarian=True)
    for _ in range(2):
        preds, label = _random_preds_labels(rng, (2, 30, 30), 6, extra)
        follow = rng.rand(*label.shape) < 0.6
        label = np.where(follow, (preds * 5 + 1) % 6, label).astype(np.int32)
        mine.update(torch.from_numpy(preds), label)
        ref.update(preds, label)
    np.testing.assert_array_equal(mine.confusion, ref.confusion)
    assert mine.compute() == ref.compute()
    for a, b in zip(mine.assignments, ref.assignments):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.histogram, ref.histogram)
    clusters = np.arange(6 + extra).reshape(1, -1)
    np.testing.assert_array_equal(mine.map_clusters(clusters), ref.map_clusters(clusters))
    lin, lin_ref = UnSegMetrics(6, 0, False), jmetrics.UnSegMetrics(6, 0, False)
    lin.update_confusion(torch.from_numpy(mine.confusion[:6]))
    lin_ref.update_confusion(ref.confusion[:6])
    assert lin.compute() == lin_ref.compute()


def _cfg(probe_res="feat"):
    cfg = micro_cfg(bf16=False)
    cfg["eval"]["probe_res"] = probe_res
    cfg["train"].update(iter_per_epoch=2, print_interval_iters=1, valid_interval_iters=2)
    return cfg


def _pair(cfg, jcfg=None):
    """The JAX Trainer of ``jcfg`` (``cfg`` when None) with its state, and
    the port's Trainer of ``cfg`` on the CPU with the same weights."""
    jtr = JTrainer(jcfg or cfg, mesh=make_mesh(2))
    ts = jtr.init_state(jax.random.PRNGKey(cfg["seed"]), img_hw=(64, 64))
    host = jax.device_get(ts)
    tr = Trainer(cfg, device="cpu")
    if "cluster_probe" not in host["probe_params"]:
        tr.evaluator.cluster_probe = None
    tr.load_state_dict(params_from_jax(host["params"], host["model_state"], tr.model.cfg,
                                       probe_params=host["probe_params"]))
    return jtr, ts, tr


def _val_batches(n, seed=5):
    """b = 2 at 64^2 without positives; 10% of the labels -1 and 5%
    num_classes (both dropped by the mask)."""
    rng = np.random.RandomState(seed)
    out = []
    for batch in synthetic_batches(seed, n, batch_size=2, res=64, num_classes=NUM_CLASSES,
                                   with_pos=False):
        label = batch["label"]
        label[rng.rand(*label.shape) < 0.1] = -1
        label[rng.rand(*label.shape) < 0.05] = NUM_CLASSES
        out.append(batch)
    return out


@pytest.mark.parametrize("probe_res", ["feat", "label"])
def test_valid_step_and_validate_match_jax(probe_res):
    jtr, ts, tr = _pair(_cfg(probe_res))
    batches = _val_batches(2)
    want = jtr.valid_step(ts, batches[0])
    got = tr.valid_step(batches[0])
    assert set(got) == set(want)
    for k in ("linear_conf", "cluster_conf", "linear_preds", "cluster_preds", "pq_indices"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["linear_conf"].sum() > 0
    for k in ("linear_loss", "cluster_loss"):
        assert got[k].item() == pytest.approx(float(want[k]), rel=1e-5), k

    val_j, val_t = jtr.validate(ts, batches), tr.validate(batches)
    assert set(val_t) == set(val_j)
    for k in ("Linear_mIoU", "Linear_Accuracy", "Cluster_mIoU", "Cluster_Accuracy"):
        assert val_t[k] == val_j[k], k
    for k in ("val_linear_loss", "val_cluster_loss"):
        assert val_t[k] == pytest.approx(val_j[k], rel=1e-5), k


def test_validate_without_cluster_probe_reports_linear_metrics(tmp_path):
    """The JAX supervised Trainer has no cluster probe; the port's
    Trainer with its cluster probe removed validates as it does."""
    cfg = _cfg()
    jcfg = copy.deepcopy(cfg)
    jcfg["train"]["supervised"] = True
    jtr, ts, tr = _pair(cfg, jcfg)
    batches = _val_batches(2, seed=6)
    val_j, val_t = jtr.validate(ts, batches), tr.validate(batches)
    assert set(val_t) == set(val_j)
    assert val_t["Cluster_mIoU"] == val_t["Linear_mIoU"] == val_j["Linear_mIoU"]
    assert val_t["Cluster_Accuracy"] == val_t["Linear_Accuracy"] == val_j["Linear_Accuracy"]
    assert val_t["val_cluster_loss"] == val_j["val_cluster_loss"] == 0.0
    assert val_t["val_linear_loss"] == pytest.approx(val_j["val_linear_loss"], rel=1e-5)
    # as JAX's: the prediction PNGs need the cluster probe, so none are written
    tr.validate(batches, visualize_to=str(tmp_path / "port"))
    jtr.validate(ts, batches, visualize_to=str(tmp_path / "jax"))
    assert not (tmp_path / "port").exists() and not (tmp_path / "jax").exists()


class _Recorder:
    """A logger for both packages' ``fit``: keeps every ``log`` call."""

    def __init__(self):
        self.records = []

    def log(self, metrics, step):
        self.records.append((step, {k: float(v) for k, v in metrics.items()}))

    def banner(self, msg):
        pass


def test_fit_matches_jax():
    """Steps 1 and 2 log train metrics, step 2 and the epoch's end log
    validations.  Train losses rtol 1e-5 as in the train-step test.  The
    validations follow two Adam steps, whose parameters agree within 1e-6
    except where a gradient sits at Adam's eps (tests/test_torch_trainer.py),
    so a few of the 16 384 pixels may change class: mIoU and Accuracy
    within 0.1 percentage points (equal on this input), validation losses
    rtol 1e-5."""
    cfg = _cfg()
    jtr, _, tr = _pair(cfg)
    train = {e: _batches(2, seed=e) for e in range(1)}
    val = _val_batches(2)
    rec_j, rec_t = _Recorder(), _Recorder()
    res_j = jtr.fit(lambda e: train[e], lambda: val, logger=rec_j, img_hw=(64, 64))
    res_t = tr.fit(lambda e: train[e], lambda: val, logger=rec_t)
    assert [s for s, _ in rec_t.records] == [s for s, _ in rec_j.records] == [1, 2, 2, 2]
    for (_, m_t), (_, m_j) in zip(rec_t.records, rec_j.records):
        assert set(m_j) <= set(m_t)
        for k, v in m_j.items():
            if k == "iter_time":
                continue
            if k.endswith(("mIoU", "Accuracy")):
                assert m_t[k] == pytest.approx(v, abs=0.1), k
            else:
                assert m_t[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    best_t, best_j = res_t["best"], res_j["best"]
    assert (best_t["iter"], best_t["epoch"]) == (best_j["iter"], best_j["epoch"])
    assert best_t["Cluster_mIoU"] == pytest.approx(best_j["Cluster_mIoU"], abs=0.1)
    assert set(res_t["state"]) == set(tr.state_dict())


def test_fit_raises_after_nonfinite_patience():
    cfg = _cfg()
    cfg["train"].update(nonfinite_patience=2, iter_per_epoch=4, valid_interval_iters=1000)
    tr = Trainer(cfg, device="cpu")
    bad = [dict(b, img=np.full_like(b["img"], np.nan)) for b in _batches(4)]
    rec = _Recorder()
    with pytest.raises(RuntimeError, match="diverged"):
        tr.fit(lambda e: bad, lambda: _val_batches(1), logger=rec)
    assert [s for s, _ in rec.records] == [1, 2]
    assert all(m["skipped"] == 1.0 for _, m in rec.records)


def test_metrics_logger_writes_the_jax_jsonl(tmp_path):
    from equss_tpu.core.logging import MetricsLogger as JLogger
    from equss_tpu_torch.core.logging import MetricsLogger

    for cls, sub in ((JLogger, "jax"), (MetricsLogger, "port")):
        logger = cls(save_dir=str(tmp_path / sub))
        logger.log({"loss": np.float32(0.25), "Cluster_mIoU": 12.5, "note": "x"}, step=3)
        logger.log({"skipped": torch.tensor(1.0)}, step=4)
        logger.close()
    port = (tmp_path / "port" / "metrics.jsonl").read_text()
    assert port == (tmp_path / "jax" / "metrics.jsonl").read_text()
    assert port.count("\n") == 2
