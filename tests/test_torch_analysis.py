"""The port's codebook analysis (``equss_tpu_torch/analysis/codebook.py``)
and parameter counting (``core/logging.py``) against the JAX package's.

Seeded numpy inputs go through both.  Counts (per-class codeword counts,
usage heatmap, parameter counts) are equal; entropies within 1e-12; the
cosine similarities within 1e-6 (numpy takes the f32 class means in f32,
the port sums in f64) and the correspondence map within 1e-6 (f32).
"""
import numpy as np
import pytest
import torch

import jax

from equss_tpu.analysis import codebook as jcb
from equss_tpu.core import logging as jlog
from equss_tpu_torch.analysis import codebook as tcb
from equss_tpu_torch.core import logging as tlog

C, M, K = 5, 3, 16


def _data(seed=0):
    rng = np.random.RandomState(seed)
    indices = rng.randint(0, K, (2, 6, 7, M)).astype(np.int32)
    labels = rng.randint(-1, C + 1, (2, 6, 7)).astype(np.int64)   # -1 and C are ignored
    labels[labels == 2] = 3                                       # class 2 absent
    feats = rng.randn(2, 6, 7, 12).astype(np.float32)
    return indices, labels, feats


def test_per_class_codeword_entropy_matches_jax():
    indices, labels, _ = _data()
    want = jcb.per_class_codeword_entropy(indices, labels, C, K)
    got = tcb.per_class_codeword_entropy(torch.from_numpy(indices), torch.from_numpy(labels),
                                         C, K)
    assert got["counts"].dtype == torch.int64 and got["entropy"].dtype == torch.float64
    np.testing.assert_array_equal(got["counts"].numpy(), want["counts"])
    for k in ("entropy", "mean_entropy_per_class"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-12)
    assert (got["entropy"][2] == 0).all() and (got["entropy"][0] > 0).all()


def test_inter_class_similarity_and_usage_match_jax():
    indices, labels, feats = _data(1)
    want = jcb.inter_class_similarity(feats, labels, C)
    got = tcb.inter_class_similarity(torch.from_numpy(feats), torch.from_numpy(labels), C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float(got[2].abs().max()) == 0.0                     # the absent class
    usage = tcb.codebook_usage_heatmap(torch.from_numpy(indices), K)
    assert usage.dtype == torch.int64
    np.testing.assert_array_equal(usage.numpy(), jcb.codebook_usage_heatmap(indices, K))


@pytest.mark.parametrize("query", [(0, 0), (3, 5)])
def test_dino_correspondence_matches_jax(query):
    rng = np.random.RandomState(2)
    fa, fb = (rng.randn(6, 7, 24).astype(np.float32) for _ in range(2))
    got = tcb.dino_correspondence(torch.from_numpy(fa), torch.from_numpy(fb), query)
    np.testing.assert_allclose(got.numpy(), jcb.dino_correspondence(fa, fb, query),
                               rtol=0, atol=1e-6)


def test_count_params_and_norm_match_jax():
    """Over a model's parameters (the port's EQUSS at vit_micro against the
    JAX model's param tree) and over a nested dict of tensors."""
    from equss_tpu.models.registry import build_model as jbuild
    from equss_tpu_torch.convert import params_from_jax
    from equss_tpu_torch.models.registry import build_model
    from test_torch_trainer import micro_cfg

    cfg = micro_cfg(bf16=False)
    jmodel = jbuild(cfg)
    params, state = jmodel.init(jax.random.PRNGKey(0), (64, 64))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), jax.device_get(state),
                                          model.cfg))
    assert tlog.count_params(model) == jlog.count_params(params)
    assert tlog.compute_param_norm(model) == pytest.approx(jlog.compute_param_norm(params),
                                                           rel=1e-6)
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(3, 4).astype(np.float32),
            "b": {"c": rng.randn(5).astype(np.float32)}}
    ttree = {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    assert tlog.count_params(ttree) == jlog.count_params(tree) == 17
    assert tlog.compute_param_norm(ttree) == pytest.approx(jlog.compute_param_norm(tree),
                                                           rel=1e-6)
    assert tlog.compute_param_norm({}) == 0.0
