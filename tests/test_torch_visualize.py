"""The port's prediction PNGs (``equss_tpu_torch/utils/visualize.py``)
against the JAX package's (``equss_tpu/utils/visualize.py``).

* ``visualization`` and ``pq_visualization`` on seeded maps (labels
  with -1, cluster ids remapped through a computed Hungarian matching of
  each package's ``UnSegMetrics``, int8 labels, tensors as input): the
  same files with the same bytes.
* ``Trainer.validate(visualize_to=...)`` at vit_micro (f32, exact PQ,
  two batches of 2 at 64^2) against the JAX ``Trainer``'s: the same
  files (linear, cluster, label and the codeword maps of
  ``eval.visualize_pq_subspaces``, upsampled by the patch size) with the
  same bytes; the valid step's predictions are bit-equal (see
  tests/test_torch_valid.py), so the PNGs are too.
"""
import os

import numpy as np
import pytest
import torch

from equss_tpu.eval import metrics as jmetrics
from equss_tpu.utils import visualize as jviz
from equss_tpu_torch.eval.metrics import UnSegMetrics
from equss_tpu_torch.utils import visualize as tviz


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_pngs(a, b, expect):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb) and len(fa) == expect
    for k in fa:
        assert fa[k] == fb[k], k


def _metrics(cls, preds, label, n, extra):
    m = cls(n, extra, compute_hungarian=True)
    m.update(preds, label)
    m.compute()
    return m


@pytest.mark.parametrize("dataset,extra", [("cocostuff27", 0), ("cityscapes", 2),
                                           ("potsdam", 0)])
def test_visualization_png_bytes_equal_jax(tmp_path, dataset, extra):
    rng = np.random.RandomState(len(dataset) + extra)
    n = 6
    cluster = rng.randint(0, n + extra, (3, 20, 24)).astype(np.int32)
    label = np.where(rng.rand(3, 20, 24) < 0.7, (cluster * 2 + 1) % n,
                     rng.randint(-1, n, (3, 20, 24))).astype(np.int8)
    linear = rng.randint(0, n, (3, 20, 24)).astype(np.int32)
    data = {"linear_preds": linear, "cluster_preds": cluster, "label": label}
    jviz.visualization(str(tmp_path / "jax"), dataset, data,
                       _metrics(jmetrics.UnSegMetrics, cluster, label, n, extra))
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    tviz.visualization(str(tmp_path / "port"), dataset, tdata,
                       _metrics(UnSegMetrics, torch.from_numpy(cluster), label, n, extra))
    _assert_same_pngs(tmp_path / "jax", tmp_path / "port", 9)
    # without metrics or labels: the raw cluster ids, no label maps
    jviz.visualization(str(tmp_path / "jax2"), dataset, data, is_label=False)
    tviz.visualization(str(tmp_path / "port2"), dataset, tdata, is_label=False)
    _assert_same_pngs(tmp_path / "jax2", tmp_path / "port2", 6)


@pytest.mark.parametrize("subspaces,upsample", [(None, 8), ([0, 2], 4)])
def test_pq_visualization_png_bytes_equal_jax(tmp_path, subspaces, upsample):
    idx = np.random.RandomState(upsample).randint(0, 256, (2, 5, 7, 3)).astype(np.int32)
    jviz.pq_visualization(str(tmp_path / "jax"), idx, subspaces=subspaces, upsample=upsample)
    tviz.pq_visualization(str(tmp_path / "port"), torch.from_numpy(idx), subspaces=subspaces,
                          upsample=upsample)
    _assert_same_pngs(tmp_path / "jax", tmp_path / "port", 2 * (3 if subspaces is None else 2))
    from PIL import Image

    big = np.asarray(Image.open(tmp_path / "port" / "pq_0" / "1.png"))
    assert big.shape == (5 * upsample, 7 * upsample, 3)


def test_validate_visualize_to_writes_jax_pngs(tmp_path):
    from test_torch_valid import _cfg, _pair, _val_batches

    cfg = _cfg()
    cfg["eval"]["visualize_pq_subspaces"] = [1, 3]
    jtr, ts, tr = _pair(cfg)
    batches = _val_batches(2)
    val_j = jtr.validate(ts, batches, visualize_to=str(tmp_path / "jax"))
    val_t = tr.validate(batches, visualize_to=str(tmp_path / "port"))
    assert val_t["Cluster_mIoU"] == val_j["Cluster_mIoU"]
    # 4 images x (linear, cluster, label, pq_1, pq_3)
    _assert_same_pngs(tmp_path / "jax", tmp_path / "port", 20)
    from PIL import Image

    pq = np.asarray(Image.open(tmp_path / "port" / "pq_3" / "0.png"))
    assert pq.shape == (64, 64, 3)                  # 8 x 8 tokens upsampled by the patch
