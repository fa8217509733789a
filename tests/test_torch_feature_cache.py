"""The port's frozen-feature cache (``equss_tpu_torch/data/feature_cache.py``)
against the JAX package's (``equss_tpu/data/feature_cache.py``).

* ``precompute_features`` of the port's EQUSS (vit_micro, f32, the JAX
  model's weights) against JAX's on the same synthetic images, 10 of
  them in batches of 4 with ``max_items`` 9: the same keys and shapes,
  labels equal, features within 1e-4 (the f32 ViT class of
  tests/test_torch_vit.py).
* A cache written by JAX read by the port's ``cached_feature_batches``
  and a cache written by the port read by JAX's: every batch equal,
  shuffled with kNN positives (the same ``RandomState`` order and
  draws), and in order without them.
* One ``train_step`` from cached features, JAX's
  tests/test_trainer.py::test_cached_feature_training flow: the port's
  gradients within 1e-4 of their scale of JAX's on the same cached batch
  (STEGO's samples fed, dropout off), the step's losses rtol 1e-5, and
  the head moves.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from equss_tpu.data import feature_cache as jfc
from equss_tpu_torch.data import feature_cache as tfc
from equss_tpu_torch.data.synthetic import synthetic_batches
from test_torch_trainer import _flat_jax_grads, _pair, _port_grads


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Data:
    """10 synthetic images at 64^2 (three batches of 4, the last partial)."""

    def batches(self, bs, shuffle=False, drop_last=False):
        out = list(synthetic_batches(7, 3, batch_size=bs, res=64, num_classes=4,
                                     with_pos=False))
        out[-1] = {k: v[:2] for k, v in out[-1].items()}
        return iter(out)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cache")
    cfg, jtr, ts, tr = _pair(bf16=False)
    params = jax.device_get(ts["params"])
    jpath = jfc.precompute_features(jtr.model, params, _Data(), str(tmp / "jax.npz"),
                                    batch_size=4, max_items=9)
    tpath = tfc.precompute_features(tr.model, _Data(), str(tmp / "port.npz"),
                                    batch_size=4, max_items=9)
    return {"jax": jpath, "port": tpath, "pair": (cfg, jtr, ts, tr)}


def test_precompute_features_matches_jax(caches):
    j, t = np.load(caches["jax"]), np.load(caches["port"])
    assert sorted(j.files) == sorted(t.files) == ["feats", "labels"]
    assert t["feats"].shape == j["feats"].shape == (9, 8, 8, 32)
    assert t["feats"].dtype == np.float32
    np.testing.assert_array_equal(t["labels"], j["labels"])
    np.testing.assert_allclose(t["feats"], j["feats"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("shuffle,with_nns", [(True, True), (False, False)],
                         ids=["shuffled-knn", "ordered"])
def test_cached_batches_equal_across_packages(caches, writer, shuffle, with_nns):
    nns = np.random.RandomState(3).randint(0, 9, (9, 5)) if with_nns else None
    kw = dict(batch_size=4, num_neighbors=7, seed=5, shuffle=shuffle)
    got = list(tfc.cached_feature_batches(caches[writer], nns, **kw))
    want = list(jfc.cached_feature_batches(caches[writer], nns, **kw))
    assert len(got) == len(want) == (2 if shuffle else 3)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["feat", "feat_pos", "label"]
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if with_nns:
        assert any(not np.array_equal(b["feat_pos"], b["feat"]) for b in got)


def test_train_step_from_cached_features_matches_jax(caches):
    cfg, jtr, ts, tr = caches["pair"]
    batch = next(tfc.cached_feature_batches(caches["jax"], None, batch_size=4, seed=0))
    batch = {k: v[:2] for k, v in batch.items()}
    rng = np.random.RandomState(9)
    batch["feat_pos"] = batch["feat_pos"][::-1].copy()
    batch["stego_coords1"] = rng.uniform(-1, 1, (2, 5, 5, 2)).astype(np.float32)
    batch["stego_coords2"] = rng.uniform(-1, 1, (2, 5, 5, 2)).astype(np.float32)
    batch["stego_perms"] = np.stack([rng.permutation(2) for _ in range(2)]).astype(np.int32)

    b = jtr._normalize_batch({k: jnp.asarray(v) for k, v in batch.items()})
    override = (b["stego_coords1"], b["stego_coords2"], b["stego_perms"])

    def loss_fn(trainable):
        params = dict(ts["params"], **trainable["model"])
        out, _ = jtr.model.apply(params, ts["model_state"], feat=b["feat"],
                                 feat_pos=b["feat_pos"], training=True,
                                 rng=jax.random.PRNGKey(1), stego_override=override)
        ev = jtr.evaluator.apply({"params": trainable["probes"]}, jtr._select_out(out),
                                 b["label"])
        return jtr._model_loss(out["aux"]) + ev["linear_loss"] + ev["cluster_loss"]

    grads = jax.grad(loss_fn)({"model": jtr._trainable(ts["params"]),
                               "probes": ts["probe_params"]})
    tr.forward_backward(batch)
    got, want = _port_grads(tr), _flat_jax_grads(jax.device_get(grads))
    assert set(got) == set(want)
    for k in got:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
    head0 = tr.model.head.state_dict()
    head0 = {k: v.clone() for k, v in head0.items()}
    ts, m_j = jtr.train_step(ts, batch)
    m_t = tr.train_step(batch)
    for key in ("loss", "model-loss", "linear-loss", "cluster-loss", "stego-loss", "vq-loss"):
        assert m_t[key] == pytest.approx(float(m_j[key]), rel=1e-5, abs=1e-7), key
    assert any(not torch.equal(v, head0[k]) for k, v in tr.model.head.state_dict().items())
