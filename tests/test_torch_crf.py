"""The port's dense CRF, probe log-probabilities and ``validate_crf`` vs
the JAX package, and its native lattice binding.

* ``_blocked_kernel_apply`` at N = 37 and 323 (neither divisible by the
  blocks 16 and 64, so the last block is ragged): f32 messages within
  1e-5, bf16 messages within 1e-4, relative to each element and to the
  output's largest magnitude (the same bf16 roundings; f32 sums run in
  another order, and a sum of mixed signs may cancel to near zero).
* ``_gaussian_conv`` within 1e-6.
* ``dense_crf`` and ``dense_crf_naive`` on 12 x 12 and 17 x 19 images,
  C in {3, 27}, ``max_iter`` in {3, 10}, ``exclude_self`` both ways.  The
  naive oracle, and the streamed pass with f32 messages where the self
  term stays: probabilities within atol 1e-4, the argmax equal wherever
  the JAX top-2 gap is >= 1e-4.  The streamed pass's self weight
  ``exp(-d2_ii / 2)`` is not exactly 1: ``d2_ii = 2 |f_i|^2 - 2 f_i . f_i``
  rounds off zero by up to an ulp of |f|^2 (0.004 at bright pixels), in
  an amount set by the order of five f32 additions, which XLA and torch
  choose differently; ``exclude_self`` subtracts the exact self term and
  leaves that residual in the message.  So with ``exclude_self`` the f32
  path is held within 1e-3 (JAX's own streamed pass is held to its naive
  oracle at 2e-3, in ``tests/test_crf.py``).  With the production bf16 messages the mean
  field is not continuous at 1e-4 either: a one-ulp change of the JAX
  function's own input moves its output by up to 1.9e-3 here (the bf16
  rounding of a message operand flips), and exp, softmax and rsqrt
  differ by an ulp between XLA and torch.  So there the probabilities
  are held within atol 1e-4 on >= 99% of elements and within 1e-2
  everywhere; the argmax as above in every case.
* The two-colour denoising case of ``tests/test_crf.py`` (> 0.97).
* ``want_log_probs`` of both probes within rtol 1e-5.
* ``Trainer.validate_crf`` on vit_micro, b = 2 at 64^2, ``max_iter`` 2,
  against the JAX ``Trainer.validate_crf`` (weights shared as in
  ``tests/test_torch_valid.py``): predictions >= 99.9% equal, the four
  metrics within 0.1 percentage points; with ``visualize_to`` the same
  PNG files as JAX's, the linear and label maps read back as the
  colormap of the refined predictions and labels, the cluster maps as
  that of the predictions remapped by the Hungarian matching, and the
  maps >= 99.9% equal to JAX's pixel for pixel.
* The native lattice (``ops/crf_native.py``, built from
  ``native/permutohedral.cpp``) against ``dense_crf``: argmax agreement
  > 0.95, as ``tests/test_crf_native.py`` holds the JAX binding.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equss_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from equss_tpu.eval.probes import Evaluator as JEvaluator
from equss_tpu.eval.probes import EvaluatorConfig as JEvaluatorConfig
from equss_tpu.ops import crf as jcrf
from equss_tpu.parallel.mesh import shard_batch
from equss_tpu_torch.convert import probes_from_flax
from equss_tpu_torch.eval.probes import Evaluator, EvaluatorConfig
from equss_tpu_torch.ops import crf
from equss_tpu_torch.ops.crf_native import dense_crf_native, permutohedral_filter
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_valid import _cfg, _pair, _val_batches


def _normalize(img01):
    return ((img01 - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)).astype(np.float32)


def _two_region_image(h, w):
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 2] = [0.9, 0.1, 0.1]
    img[:, w // 2:] = [0.1, 0.1, 0.9]
    return img


@pytest.mark.parametrize("message", ["f32", "bf16"])
@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("n", [37, 323])
def test_blocked_kernel_apply_matches_jax(n, block, message):
    rng = np.random.RandomState(n + block)
    feats = rng.randn(n, 5).astype(np.float32)
    vals = rng.randn(n, 4).astype(np.float32)
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[message]
    want = np.asarray(jcrf._blocked_kernel_apply(jnp.asarray(feats), jnp.asarray(vals), block, jd))
    got = crf._blocked_kernel_apply(torch.from_numpy(feats), torch.from_numpy(vals), block, td)
    assert got.dtype == torch.float32 and got.shape == (n, 4)
    tol = 1e-5 if message == "f32" else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def test_gaussian_conv_matches_jax():
    x = np.random.RandomState(0).rand(13, 11, 5).astype(np.float32)
    for sigma in (1.0, 2.5):
        want = np.asarray(jcrf._gaussian_conv(jnp.asarray(x), sigma))
        got = crf._gaussian_conv(torch.from_numpy(x), sigma).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _crf_inputs(h, w, c, seed):
    rng = np.random.RandomState(seed)
    return _normalize(rng.rand(h, w, 3)), (2 * rng.randn(h, w, c)).astype(np.float32)


def _assert_argmax_where_decided(got, want):
    top2 = np.sort(want, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] >= 1e-4
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("max_iter", [3, 10])
@pytest.mark.parametrize("c", [3, 27])
@pytest.mark.parametrize("hw", [(12, 12), (17, 19)])
def test_dense_crf_matches_jax(hw, c, max_iter, exclude_self):
    img, logits = _crf_inputs(*hw, c, seed=hw[1] * c + max_iter)
    kw = dict(max_iter=max_iter, block=32, exclude_self=exclude_self)
    jargs = (jnp.asarray(img), jnp.asarray(logits), jcrf.CRFConfig(**kw))
    targs = (torch.from_numpy(img), torch.from_numpy(logits), crf.CRFConfig(**kw))

    want = np.asarray(jcrf.dense_crf_naive(*jargs))
    got = crf.dense_crf_naive(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    _assert_argmax_where_decided(got, want)

    want = np.asarray(jcrf.dense_crf(*jargs))               # bf16 messages
    got = crf.dense_crf(*targs).numpy()
    assert got.shape == (*hw, c)
    diff = np.abs(got - want)
    assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 1e-2, diff.max()
    _assert_argmax_where_decided(got, want)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_dense_crf_f32_messages_match_jax(exclude_self, monkeypatch):
    """Both packages' streamed pass with f32 messages, 17 x 19, C = 27,
    10 iterations (the JAX side's message dtype set by a partial)."""
    monkeypatch.setattr(jcrf, "_blocked_kernel_apply", functools.partial(
        jcrf._blocked_kernel_apply, message_dtype=jnp.float32))
    img, logits = _crf_inputs(17, 19, 27, seed=11)
    kw = dict(max_iter=10, block=32, exclude_self=exclude_self)
    want = np.asarray(jcrf.dense_crf(jnp.asarray(img), jnp.asarray(logits), jcrf.CRFConfig(**kw)))
    got = crf.dense_crf(torch.from_numpy(img), torch.from_numpy(logits),
                        crf.CRFConfig(**kw), message_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= (1e-3 if exclude_self else 1e-4)
    _assert_argmax_where_decided(got, want)


def test_batched_crf_is_dense_crf_per_image():
    rng = np.random.RandomState(3)
    imgs = torch.from_numpy(_normalize(rng.rand(2, 8, 9, 3)))
    lp = torch.from_numpy(rng.randn(2, 8, 9, 4).astype(np.float32))
    cfg = crf.CRFConfig(max_iter=2, block=16)
    out = crf.batched_crf(imgs, lp, cfg)
    assert out.shape == (2, 8, 9, 4)
    for i in range(2):
        assert torch.equal(out[i], crf.dense_crf(imgs[i], lp[i], cfg))


def _noisy_two_colour(h=24, w=24, seed=2):
    """Left half red, right half blue; unaries +2 on the true class, 25%
    of the pixels flipped."""
    rng = np.random.RandomState(seed)
    true = np.zeros((h, w), np.int32)
    true[:, w // 2:] = 1
    logits = np.zeros((h, w, 2), np.float32)
    noisy = np.where(rng.rand(h, w) < 0.25, 1 - true, true)
    logits[np.arange(h)[:, None], np.arange(w)[None], noisy] = 2.0
    return _two_region_image(h, w), true, noisy, logits


def test_crf_denoises_labels_along_color_edges():
    img01, true, noisy, logits = _noisy_two_colour()
    out = crf.dense_crf(torch.from_numpy(_normalize(img01)), torch.from_numpy(logits),
                        crf.CRFConfig(max_iter=10, block=64))
    after = (out.argmax(-1).numpy() == true).mean()
    assert after > (noisy == true).mean() and after > 0.97, after


def test_native_crf_matches_dense_crf():
    img01, true, _, logits = _noisy_two_colour()
    log_p = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    cfg = crf.CRFConfig(max_iter=10, block=64)
    native = dense_crf_native(img01 * 255.0, log_p, cfg).argmax(-1)
    assert (native == true).mean() > 0.95
    exact = crf.dense_crf(torch.from_numpy(_normalize(img01)), torch.from_numpy(log_p), cfg)
    assert (exact.argmax(-1).numpy() == native).mean() > 0.95

    rng = np.random.RandomState(0)                   # the lattice filter itself
    feats, vals = rng.randn(300, 5).astype(np.float32), rng.randn(300, 3).astype(np.float32)
    out = permutohedral_filter(feats, vals)
    expected = np.exp(-0.5 * ((feats[:, None] - feats[None]) ** 2).sum(-1)) @ vals
    for c in range(3):
        assert np.corrcoef(out[:, c], expected[:, c])[0, 1] > 0.95


@pytest.mark.parametrize("probe_res", ["feat", "label"])
def test_want_log_probs_match_jax(probe_res):
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 8, 8, 16).astype(np.float32)
    label = rng.randint(-1, 5, (2, 32, 32)).astype(np.int32)
    jev = JEvaluator(JEvaluatorConfig(embed_dim=16, num_classes=5, probe_res=probe_res))
    params = jev.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(label))["params"]
    want = jev.apply({"params": params}, jnp.asarray(feats), jnp.asarray(label),
                     want_log_probs=True)
    ev = Evaluator(EvaluatorConfig(embed_dim=16, num_classes=5, probe_res=probe_res),
                   torch.Generator().manual_seed(0))
    ev.load_state_dict(probes_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = ev(torch.from_numpy(feats), torch.from_numpy(label), want_log_probs=True)
    for k in ("linear_log_probs", "cluster_log_probs"):
        assert got[k].shape == (2, 32, 32, 5), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    with torch.no_grad():
        assert "linear_log_probs" not in ev(torch.from_numpy(feats), torch.from_numpy(label))


def test_validate_crf_matches_jax(tmp_path):
    cfg = _cfg()
    cfg["eval"]["crf"] = {"max_iter": 2}
    jtr, ts, tr = _pair(cfg)
    batches = _val_batches(2, seed=8)
    val_j, val_t = jtr.validate_crf(ts, batches), tr.validate_crf(batches)
    # the JAX step as validate_crf compiled it
    want = jtr._valid_crf_step(ts, shard_batch(jtr.mesh, jtr._host_trim(batches[0])))
    got = tr.valid_crf_step(batches[0])
    for k in ("linear_preds", "cluster_preds"):
        assert got[k].shape == (2, 64, 64), k
        assert (got[k].numpy() == np.asarray(want[k])).mean() >= 0.999, k
    assert set(val_t) == set(val_j)
    for k, v in val_j.items():
        assert val_t[k] == pytest.approx(v, abs=0.1), k
    _validate_crf_pngs(tmp_path, jtr, ts, tr, batches)


def _validate_crf_pngs(tmp_path, jtr, ts, tr, batches):
    """``validate_crf(visualize_to=...)`` of both packages: the file sets
    equal, the port's maps the colormap of its own refined predictions
    (the cluster ones remapped), >= 99.9% of pixels equal to JAX's."""
    from PIL import Image

    from equss_tpu_torch.data.catalog import create_pascal_label_colormap
    from equss_tpu_torch.eval.metrics import UnSegMetrics

    jtr.validate_crf(ts, batches, visualize_to=str(tmp_path / "jax"))
    tr.validate_crf(batches, visualize_to=str(tmp_path / "port"))
    read = lambda root, sub, i: np.asarray(Image.open(root / sub / f"{i}.png"))  # noqa: E731
    names = lambda root: sorted(os.listdir(root))                               # noqa: E731
    assert names(tmp_path / "jax") == names(tmp_path / "port") == ["cluster", "label", "linear"]
    steps = [tr.valid_crf_step(b) for b in batches]
    cluster_m = UnSegMetrics(tr.tc.num_classes, tr.tc.extra_classes, compute_hungarian=True)
    cluster_m.update_confusion(sum(s["cluster_conf"] for s in steps))
    cluster_m.compute()
    cmap = create_pascal_label_colormap()
    maps = {"linear": np.concatenate([s["linear_preds"].numpy() for s in steps]),
            "cluster": cluster_m.map_clusters(
                np.concatenate([s["cluster_preds"].numpy() for s in steps])),
            "label": np.concatenate([b["label"] for b in batches])}
    for sub, arr in maps.items():
        assert len(os.listdir(tmp_path / "port" / sub)) == len(arr) == 4
        for i in range(len(arr)):
            want = cmap[np.clip(arr[i], 0, None)].astype(np.uint8)
            want[arr[i] < 0] = 0
            got = read(tmp_path / "port", sub, i)
            np.testing.assert_array_equal(got, want, err_msg=f"{sub}/{i}")
            same = (got == read(tmp_path / "jax", sub, i)).all(-1).mean()
            assert same >= 0.999, (sub, i, same)
