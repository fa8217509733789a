"""The port's twin config, twin corpus and exact-vs-lattice CRF comparison
(``equss_tpu_torch/parity``) against the JAX package's
(``equss_tpu/parity/twin.py``, ``equss_tpu/parity/crf_compare.py``).

* ``make_twin_config`` equal to JAX's dict for pqgo, stego, sl and spq.
* ``make_corpus`` bit-equal to JAX's for seed 0 at 32^2.
* From JAX's initial twin-config state (vit_small, f32, exact PQ; the
  state JAX's ``run_crf_compare`` starts from at ``seed`` 0 and 32^2)
  carried across with ``convert.params_from_jax``, no train step, b = 2,
  one val batch: the linear and cluster log-probs within 1e-4 of their
  scale (f32 sums in another order); the "none" predictions equal; the
  exact-refined argmax equal to JAX's ``dense_crf``'s wherever JAX's
  top-2 gap is >= 1e-4 (the bar of ``tests/test_torch_crf.py``: with bf16
  messages the mean field is not continuous below that); the lattice
  argmax equal to JAX's lattice argmax (the same C++ source, fed RGB
  rounded in another order) on >= 99.9% of pixels; every metric of
  ``compare`` within 0.1 points of JAX's ``run_crf_compare`` with
  ``n_steps=0``.
* ``run_crf_compare(n_steps=2, ...)`` on the CPU returns JAX's keys with
  finite values; without ``device`` it takes the card and raises here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equss_tpu.data.transforms import unnormalize_images as junnormalize_images
from equss_tpu.ops.crf import CRFConfig as JCRFConfig
from equss_tpu.ops.crf import dense_crf as jdense_crf
from equss_tpu.ops.crf_native import batched_crf_native as jbatched_crf_native
from equss_tpu.parallel.mesh import make_mesh
from equss_tpu.parity import crf_compare as jcrf_compare
from equss_tpu.parity import twin as jtwin
from equss_tpu.train.trainer import Trainer as JTrainer
from equss_tpu_torch.convert import params_from_jax
from equss_tpu_torch.data.transforms import normalize_images
from equss_tpu_torch.ops.crf import CRFConfig
from equss_tpu_torch.parity import crf_compare, twin
from equss_tpu_torch.train.trainer import Trainer
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)

RES, BATCH, SEED = 32, 2, 0
METRIC_KEYS = ("Cluster_mIoU", "Cluster_Accuracy", "Linear_mIoU", "Linear_Accuracy")


@pytest.mark.parametrize("variant", ["pqgo", "stego", "sl", "spq"])
def test_make_twin_config_equals_jax(variant):
    assert twin.make_twin_config(variant=variant) == jtwin.make_twin_config(variant=variant)
    wide = dict(embed_dim=1024, num_pq=64, num_codebook=256, num_classes=27)
    assert (twin.make_twin_config(variant=variant, **wide)
            == jtwin.make_twin_config(variant=variant, **wide))


def test_make_corpus_is_bit_equal_to_jax():
    got, want = twin.make_corpus(SEED, 2, 1, BATCH, RES, 4), jtwin.make_corpus(
        SEED, 2, 1, BATCH, RES, 4)
    for g_split, w_split in zip(got, want):
        assert len(g_split) == len(w_split)
        for g, w in zip(g_split, w_split):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def shared():
    """JAX's twin trainer in the state its ``run_crf_compare`` starts from
    (``seed`` 0, 32^2), the port's trainer on the CPU with the same
    weights, and the val corpus."""
    cfg = twin.make_twin_config()
    jtr = JTrainer(cfg, mesh=make_mesh(1))
    ts = jtr.init_state(jax.random.PRNGKey(SEED), img_hw=(RES, RES))
    host = jax.device_get(ts)
    tr = Trainer(cfg, device="cpu")
    tr.load_state_dict(params_from_jax(host["params"], host["model_state"], tr.model.cfg,
                                       probe_params=host["probe_params"]))
    _, val = twin.make_corpus(SEED, 1, 1, BATCH, RES, cfg["num_classes"])
    return jtr, ts, tr, val


def _scaled_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_compare_matches_jax_from_shared_weights(shared):
    jtr, ts, tr, val = shared
    b = val[0]
    # the JAX side, as its run_crf_compare computes it
    img_j = jtr._normalize_batch({"img": jnp.asarray(b["img"])})["img"]
    out, _ = jtr.model.apply(ts["params"], ts["model_state"], img_j, training=False)
    ev = jtr.evaluator.apply({"params": ts["probe_params"]}, jtr._select_out(out),
                             jnp.asarray(b["label"]), want_log_probs=True)
    want_lp = {k: np.asarray(ev[f"{k}_log_probs"]) for k in ("linear", "cluster")}
    jcfg = JCRFConfig()
    want_exact = {k: np.asarray(jax.vmap(lambda i, lp: jdense_crf(i, lp, jcfg))(
        img_j, jnp.asarray(v))) for k, v in want_lp.items()}
    rgb255 = np.asarray(junnormalize_images(img_j)) * 255.0
    want_lattice = {k: np.argmax(jbatched_crf_native(rgb255, v, jcfg), -1)
                    for k, v in want_lp.items()}

    img_n = normalize_images(torch.from_numpy(b["img"]))
    np.testing.assert_array_equal(img_n.numpy(), np.asarray(img_j))
    lin, clu = crf_compare.log_probs(tr, img_n, torch.from_numpy(b["label"]).long())
    got_lp = {"linear": lin.numpy(), "cluster": clu.numpy()}
    cfg = CRFConfig()
    for k in ("linear", "cluster"):
        assert _scaled_err(got_lp[k], want_lp[k]) <= 1e-4, k
        np.testing.assert_array_equal(got_lp[k].argmax(-1), want_lp[k].argmax(-1), err_msg=k)
        exact = crf_compare.refine_exact(img_n, torch.from_numpy(got_lp[k]), cfg).numpy()
        top2 = np.sort(want_exact[k], -1)[..., -2:]
        decided = top2[..., 1] - top2[..., 0] >= 1e-4
        assert decided.mean() > 0.9, k
        np.testing.assert_array_equal(exact[decided], want_exact[k].argmax(-1)[decided],
                                      err_msg=k)
        lattice = crf_compare.refine_lattice(img_n, torch.from_numpy(got_lp[k]), cfg)
        assert (lattice == want_lattice[k]).mean() >= 0.999, k

    got = crf_compare.compare(tr, val)
    want = jcrf_compare.run_crf_compare(n_steps=0, batch_size=BATCH, res=RES, n_val=1,
                                        seed=SEED)
    assert got["metrics"]["none"] == want["metrics"]["none"]
    for row in ("exact", "lattice"):
        for k in METRIC_KEYS:
            assert got["metrics"][row][k] == pytest.approx(want["metrics"][row][k],
                                                           abs=0.1), (row, k)
    assert got["n_imgs"] == want["n_imgs"] == BATCH and got["res"] == want["res"] == RES


def test_run_crf_compare_on_the_cpu_returns_jax_keys():
    got = crf_compare.run_crf_compare(n_steps=2, batch_size=BATCH, res=RES, n_val=1,
                                      device="cpu")
    assert set(got) == {"metrics", "agreement", "ms_per_img", "n_imgs", "res"}
    assert set(got["metrics"]) == {"none", "exact", "lattice"}
    for row in got["metrics"].values():
        assert set(row) == set(METRIC_KEYS)
        assert all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in row.values())
    assert set(got["agreement"]) == {"cluster", "linear"}
    assert all(0.5 <= v <= 1.0 for v in got["agreement"].values())
    assert set(got["ms_per_img"]) == {"exact", "lattice"}
    assert all(v > 0 for v in got["ms_per_img"].values())
    assert got["n_imgs"] == BATCH and got["res"] == RES
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            crf_compare.run_crf_compare(n_steps=0, batch_size=BATCH, res=RES, n_val=1)
