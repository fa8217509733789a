"""The ``models/variants.py`` slices against the JAX package: ``pqgocls``,
``cluster`` (margin and SwAV), ``res``, ``hihi`` (UnSeg), ``new`` (NewVQ)
and ``spq``.

* One training forward and backward per family on vit_micro, b = 2 at
  32^2, dropout off, on the JAX model's weights and state
  (``convert.params_from_jax``), the same view ``aug_img`` on both sides
  and JAX's own InfoNCE negatives and STEGO samples fed to the port: every
  aux term within rtol 1e-5 (CLUB's and the margin's 1e-4: the port's
  forms sum in another order); the trainable gradients within 1e-4 of their
  largest magnitude (a bias right ahead of a BatchNorm, whose gradient is
  zero up to rounding on both sides, within 1e-4 of the model's largest);
  the new state within 1e-4 of its scale: the SwAV queue and counters,
  the EMA head, the quantizer's counts, the BatchNorm statistics, the
  CLUB encoder after ``mi_iter`` Adam steps and its moments (an Adam
  step normalises each element's gradient, so a near-zero gradient's
  rounding moves an element by a fraction of the learning rate: the CLUB
  encoder is also allowed 1e-3 of ``optimizer.club_enc.lr``).  SwAV runs
  at its first step (prototypes frozen, queue off) and past both gates
  with a partly filled queue.
* ``pqgocls``'s pseudo-labels and NewVQ's indices bit-equal to JAX's with
  exact assignments, and >= 99.5% equal with bf16 ones.
* UnSeg's chain of two quantizers (``embed_dims [32, 32]``,
  ``num_codebooks [8, 8]``) with ``concat`` and ``sum`` aggregation and
  ``last_norm``, in training and in eval, as the forward above; NewVQ's
  stage 1 given JAX's k-means draws: the same selected rows, the same
  indices and the training forward's bars (``recon-loss`` rtol 1e-5);
  SPQ's ``soft_quantize``: z_q and the assignment within 1e-5 relative.
* The trainer: the in-step photometric view (drawn from the trainer's
  generator, a batch's own ``aug_img`` first, ``train.photometric_aug:
  false`` off); a non-finite step leaves every parameter, buffer and
  optimizer state as it was, and a finite one moves the model state; a
  mid-epoch resume of ``res`` and ``cluster_swav`` through ``cli.run`` is
  bit-exact, state included; the JAX train state of each family converts
  (``convert.train_state_from_jax``) and loads; ``pqgocls``'s and
  UnSeg's ``vq0`` evaluation equals JAX's ``validate``; the configs train
  and validate through ``cli.run`` at vit_micro.
"""
import copy
import glob
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equss_tpu.core.config import load_config
from equss_tpu.losses.stego import super_perm
from equss_tpu.models import registry as jregistry
from equss_tpu.parallel.mesh import make_mesh
from equss_tpu.train.trainer import LOSS_WEIGHT_MAP
from equss_tpu.train.trainer import Trainer as JTrainer
from equss_tpu_torch import cli
from equss_tpu_torch.convert import (_trainable_from_flax, batch_stats_prefix, params_from_jax,
                                     state_from_flax, train_state_from_jax)
from equss_tpu_torch.data.synthetic import synthetic_batches
from equss_tpu_torch.data.transforms import normalize_images
from equss_tpu_torch.models import registry
from equss_tpu_torch.models.variants import codebook_usage_percentiles
from equss_tpu_torch.train.trainer import Trainer
from test_torch_checkpoint import _flat
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_valid import _val_batches

CONFIGS = ["pqgo_cls_cocostuff27", "cluster_margin_cocostuff27", "cluster_swav_cocostuff27",
           "res_cocostuff27", "unseg_cocostuff27", "new_vq_cocostuff27", "spq_cocostuff27",
           "vae_cocostuff27", "info_cocostuff27", "contra_cocostuff27", "ema_cocostuff27"]
B, RES = 2, 32
N = B * (RES // 8) ** 2


def micro(name, precision="exact"):
    """The config at vit_micro in f32, dropout off; pqgocls and NewVQ with
    ``precision`` assignments, pqgocls's STEGO at 5 samples, 2 negatives."""
    cfg = load_config(f"configs/{name}.yaml")
    cfg["model"]["pretrained"].update(model_type="vit_micro", precision="f32", dropout=False)
    if name.startswith(("pqgo", "new_vq")):
        cfg["model"]["vq"]["assign_precision"] = precision
    if name.startswith("pqgo"):
        cfg["loss"]["stego"].update(correlation_precision="exact", feature_samples=5,
                                    neg_samples=2)
    return cfg


def _mcfg():
    return types.SimpleNamespace(model_type="vit_micro")


def _t(x):
    return torch.from_numpy(np.array(x))


def _draws(name, cfg, rng):
    """JAX's draws inside ``apply`` for ``rng``, as the port's overrides:
    InfoNCE negatives, STEGO samples, the quantizers' Gumbel noise (Info)
    and split noise (Contra), EMAModel's proxy indices and dropout masks."""
    kw = {}
    vq = cfg["model"].get("vq", {})
    if name.startswith("info"):
        for i, k in enumerate(vq["num_codebooks"]):
            key = jax.random.split(jax.random.fold_in(rng, i))[1]
            kw[f"gumbel_{i}"] = _t(jax.random.gumbel(key, (N, 1, k)))
    if name.startswith("contra"):
        for i, (k, e, m) in enumerate(zip(vq["num_codebooks"], vq["embed_dims"], vq["num_pq"])):
            key = jax.random.split(jax.random.fold_in(rng, i))[1]
            kw[f"split_noise_{i}"] = _t(jax.random.normal(key, (m, k, e // m)))
    if name.startswith("ema"):
        keys = jax.random.split(rng, 4)
        mb, ince = cfg["model"]["memory_bank"], cfg["loss"]["info_nce"]
        C, Q = mb["n_cluster"], mb["queue_size"]
        k_q, k_n = jax.random.split(keys[2])
        kw["proxy_q_idx"] = _t(jax.random.randint(k_q, (C, ince["num_queries"]), 0, Q))
        kw["proxy_neg_idx"] = _t(jax.random.randint(
            k_n, (C, ince["num_queries"] * ince["num_neg"]), 0, (C - 1) * Q))
        pre = cfg["model"]["pretrained"]
        if pre["dropout"]:
            feat_dim = jregistry.build_model(cfg).feat_dim
            kw["dropout_keep"] = torch.stack([_t(jax.random.bernoulli(
                keys[j], 1.0 - pre["drop_prob"], (B, 1, 1, feat_dim))) for j in (0, 1)])
    if name.startswith(("cluster", "res", "new_vq", "spq")):
        fold = {"cluster": 23, "res": 3}.get(name.split("_")[0], 7)
        neg = (cfg["loss"].get("info_nce", {}) or {}).get("neg_sample", 10)
        kw["info_nce_idx"] = _t(jax.random.randint(jax.random.fold_in(rng, fold), (N, neg), 0, N))
    if name.startswith("pqgo"):
        k1, k2, k_neg = jax.random.split(jax.random.split(rng, 4)[2], 3)
        c1 = jax.random.uniform(k1, (B, 5, 5, 2)) * 2.0 - 1.0
        c2 = jax.random.uniform(k2, (B, 5, 5, 2)) * 2.0 - 1.0
        perms = np.stack([super_perm(k, B) for k in jax.random.split(k_neg, 2)])
        kw["stego_override"] = (_t(c1), _t(c2), _t(perms))
    return kw


def _pair(name, precision="exact", swav_it=None, cfg=None):
    cfg = cfg or micro(name, precision)
    jm = jregistry.build_model(cfg)
    params, state = jax.device_get(jm.init(jax.random.PRNGKey(0), img_hw=(RES, RES)))
    if swav_it is not None:
        # a partly filled queue of unit rows, as the model inserts them:
        # 3000 of 4096 slots live
        queue = np.random.RandomState(4).randn(*state["swav_queue"].shape).astype(np.float32)
        queue /= np.linalg.norm(queue, axis=-1, keepdims=True)
        state = dict(state, swav_queue=queue, swav_queue_n=np.int32(3000),
                     swav_it=np.int32(swav_it))
    tm = registry.build_model(cfg, device="cpu", seed=5)
    tm.load_state_dict(params_from_jax(params, state, _mcfg()))
    return cfg, jm, params, state, tm


def _rel_close(got, want, rtol, what, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(initial=0.0), floor)
    assert np.abs(got - want).max(initial=0.0) <= rtol * scale, what


# biases whose every path to the loss runs through a BatchNorm (directly,
# through a biasless Dense, or through a residual sum that the next block
# normalises): their gradient is zero up to rounding.  NewVQ's encoder
# output biases also reach the loss past the quantizer (commitment,
# InfoNCE), where their small gradient is what is left of the decoder
# path's cancellation
_AHEAD_OF_BN = ("agg.bias", "dec.dec_0.conv1.bias", "net.agg.bias",
                *(f"net.dec.dec_{i}.conv{j}.bias" for i in range(3) for j in (1, 2)
                  if (i, j) != (2, 2)),
                "net.dec.dec_0.norm1.bias", "net.enc.enc_0.conv2.bias",
                "net.enc.enc_0.conv_shortcut.bias")
# NewVQ's module-flavour decoder: norm2 normalises norm1's output through a
# biasless Dense, so the running mean it records is zero up to rounding
_ZERO_MEAN_STATS = ("net.dec.dec_0.norm2.mean",)


@pytest.mark.parametrize("name,swav_it", [
    ("pqgo_cls_cocostuff27", None), ("cluster_margin_cocostuff27", None),
    ("cluster_swav_cocostuff27", 0), ("cluster_swav_cocostuff27", 200),
    ("res_cocostuff27", None), ("unseg_cocostuff27", None), ("new_vq_cocostuff27", None),
    ("spq_cocostuff27", None), ("vae_cocostuff27", None), ("info_cocostuff27", None),
    ("contra_cocostuff27", None), ("ema_cocostuff27", None)])
def test_training_forward_matches_jax(name, swav_it):
    _training_forward_matches_jax(name, _pair(name, swav_it=swav_it), swav_it)


def _training_forward_matches_jax(name, pair, swav_it=None, kw=None, same_order=True):
    """One training forward and backward of ``pair`` (``_pair``'s) on both
    sides, the bars of the module docstring; ``kw`` adds inputs of the
    port's forward; ``same_order=False`` leaves the indices to the caller.
    Returns (JAX's out, the port's out)."""
    cfg, jm, params, state, tm = pair
    rs = np.random.RandomState(1)
    img, pos, aug = (rs.randn(B, RES, RES, 3).astype(np.float32) for _ in range(3))
    rng = jax.random.PRNGKey(1)
    weights = {aux: float(cfg["loss"][w]) for w, aux in LOSS_WEIGHT_MAP.items()
               if float(cfg["loss"].get(w, 0.0) or 0.0) > 0.0}
    for part, w in (cfg["loss"].get("contra_weight", {}) or {}).items():
        if float(w) > 0.0:                  # the JAX trainer's nested weights
            weights[f"contra-loss-{part}"] = float(w)

    def loss_j(trainable):
        out, new_state = jm.apply(dict(params, **trainable), state, jnp.asarray(img),
                                  img_pos=jnp.asarray(pos), aug_img=jnp.asarray(aug),
                                  training=True, rng=rng)
        return sum(w * out["aux"][k] for k, w in weights.items()), (out, new_state)

    trainable = {k: v for k, v in params.items() if k != "backbone"}
    (_, (out_j, state_j)), grads_j = jax.value_and_grad(loss_j, has_aux=True)(trainable)
    out_t = tm(_t(img), _t(pos), aug_img=_t(aug), training=True,
               generator=torch.Generator(), **_draws(name, cfg, rng), **(kw or {}))
    sum(w * out_t["aux"][k] for k, w in weights.items()).backward()

    scalars = {k for k, v in out_j["aux"].items() if np.ndim(v) == 0}
    assert scalars <= set(out_t["aux"]) and set(weights) <= scalars
    for k in scalars:
        # the O(n d) CLUB and the blocked margin sum in another order
        rtol = 1e-4 if k.startswith(("club-loss", "margin")) else 1e-5
        np.testing.assert_allclose(float(out_t["aux"][k].detach()), float(out_j["aux"][k]),
                                   rtol=rtol, atol=1e-7, err_msg=k)

    want = _trainable_from_flax(jax.device_get(grads_j))
    got = {k: p.grad for k, p in tm.named_parameters() if not k.startswith("backbone.")}
    assert set(got) == set(want)
    largest = max(np.abs(w.numpy()).max() for w in want.values())
    for k, g in got.items():
        w = want[k].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        _rel_close(g, w, 1e-4, k, floor=largest if k in _AHEAD_OF_BN else 0.0)
    if swav_it is not None:      # frozen prototypes take no gradient
        frozen = swav_it < tm.freeze_protos_niter
        assert (np.abs(want["prototypes"].numpy()).max() == 0) == frozen
        assert (float(tm.prototypes.grad.abs().max()) == 0) == frozen

    new_j = state_from_flax(jax.device_get(state_j), batch_stats_prefix(params))
    new_t = out_t.get("state", {})
    buffers = {k for k, _ in tm.named_buffers() if not k.startswith("backbone.")}
    assert set(new_t) == set(new_j) == buffers
    lr = float(cfg["optimizer"].get("club_enc", {}).get("lr", 0.0))
    for k, v in new_t.items():
        assert v.dtype == new_j[k].dtype, k
        if k.startswith("club_enc."):
            np.testing.assert_allclose(v.numpy(), new_j[k].numpy(), rtol=0,
                                       atol=max(1e-4 * np.abs(new_j[k].numpy()).max(),
                                                1e-3 * lr), err_msg=k)
        elif k in _ZERO_MEAN_STATS:
            # to 1e-4 of the spread of what it averages, a zero-mean product
            spread = float(np.sqrt(np.abs(new_j[k[:-4] + "var"].numpy()).max()))
            _rel_close(v.detach().numpy(), new_j[k].numpy(), 1e-4, k, floor=spread)
        else:
            _rel_close(v.detach().numpy(), new_j[k].numpy(), 1e-4, k)
    if "indices" in out_j and same_order:
        np.testing.assert_array_equal(out_t["indices"].numpy(), np.asarray(out_j["indices"]))
    if name.startswith("pqgo"):
        # the EMA head moved toward the student: by (1 - momentum) of the gap
        assert not torch.equal(new_t["ema_head.cluster1.weight"],
                               tm.ema_head.cluster1.weight)
    if name.startswith("res"):
        assert float(out_t["aux"]["club-enc-loss"]) < float(out_t["aux"]["club-enc-loss-first"])
    return out_j, out_t


def test_ema_with_dropout_matches_jax_given_its_masks():
    """EMAModel with channel dropout on both views, JAX's masks
    (``bernoulli`` of ``split(rng, 4)[0]`` and ``[1]``) fed to the port as
    ``dropout_keep``: the training forward's bars; and a bank initialised
    (``bank_initialized`` 1) keeps its queue's old entries where no pixel
    clears the margin."""
    cfg = micro("ema_cocostuff27")
    cfg["model"]["pretrained"]["dropout"] = True
    _training_forward_matches_jax("ema_cocostuff27", _pair("ema_cocostuff27", cfg=cfg))
    cfg = micro("ema_cocostuff27")
    cfg["model"]["memory_bank"]["margin"] = 10.0         # no pixel clears it
    cfg_, jm, params, state, tm = _pair("ema_cocostuff27", cfg=cfg)
    queue = np.random.RandomState(5).randn(*state["queue"].shape).astype(np.float32)
    state = dict(state, queue=queue, bank_initialized=np.int32(1))
    tm.load_state_dict(params_from_jax(params, state, _mcfg()))
    out_j, out_t = _training_forward_matches_jax("ema_cocostuff27",
                                                 (cfg_, jm, params, state, tm))
    np.testing.assert_array_equal(out_t["state"]["queue"].numpy(), queue)


def _data_init_cfg(name, mode="kmeans"):
    """``name`` at micro widths with a data-initialised codebook of K = 16
    (``need_initialized: mode``); EMAModel as it is."""
    cfg = micro(name)
    vq = cfg["model"].get("vq")
    if vq is not None and not name.startswith("ema"):
        vq.update(need_initialized=mode, num_codebooks=[16] * len(vq["num_codebooks"]))
    return cfg


def _jax_data_init_draws(name, jm, rng, n):
    """The k-means++ / ``rand`` draws of JAX's ``data_init(rng)`` for each
    quantizer (EMAModel: its bank's k-means), as the port's keywords."""
    from test_torch_kmeans import jax_plus_plus_draws

    if name.startswith("ema"):
        first, noise = jax_plus_plus_draws(rng, 1, n, jm.n_cluster)
        return {"kmeans_first_0": first, "kmeans_gumbel_0": noise}
    if name.startswith("pqgo"):         # EQUSS: one quantizer on the key itself
        keys, rows = [rng], [n]
    else:                                # a chain: fold_in(rng, level)
        keys = [jax.random.fold_in(rng, i) for i in range(len(jm.pq_cfgs))]
        # the VAE's top level quantizes at half resolution
        rows = [n // 4, n] if name.startswith("vae") else [n] * len(keys)
    cfgs = jm.pq_cfgs if hasattr(jm, "pq_cfgs") else [jm.cfg.pq]
    draws = {}
    for i, (c, key, r) in enumerate(zip(cfgs, keys, rows)):
        if c.need_initialized == "rand":
            draws[f"rand_idx_{i}"] = _t(jax.random.randint(key, (c.num_pq, c.num_codebook),
                                                           0, r))
        else:
            first, noise = jax_plus_plus_draws(key, c.num_pq, r, c.num_codebook)
            draws[f"kmeans_first_{i}"], draws[f"kmeans_gumbel_{i}"] = first, noise
    return draws


@pytest.mark.parametrize("name,mode", [
    ("pqgo_cocostuff27", "kmeans"), ("pqgo_cocostuff27", "rand"), ("unseg_cocostuff27", "kmeans"),
    ("contra_cocostuff27", "kmeans"), ("vae_cocostuff27", "kmeans"),
    ("info_cocostuff27", "kmeans"), ("ema_cocostuff27", None)])
def test_data_init_chain_matches_jax(name, mode):
    """``data_init`` given JAX's draws (``fold_in(rng, i)`` per quantizer in
    the chains): every tensor it sets within 1e-5 of its scale of JAX's
    new params and state, each level fed by the previous one's new
    codebook (UnSeg / Contra, VAE), Info's through the running feature;
    EMAModel's centroids, queue and flag (each cluster's queue as a set
    of rows: the order of its supports follows each side's rounding of
    near-equal distances)."""
    cfg = _data_init_cfg(name, mode)
    cfg_, jm, params, state, tm = _pair(name, cfg=cfg)
    assert tm.needs_data_init and jm.needs_data_init
    img = np.random.RandomState(6).randn(4, RES, RES, 3).astype(np.float32)
    rng = jax.random.PRNGKey(8)
    n = 4 * (RES // 8) ** 2
    p_j, s_j = jm.data_init(params, state, jnp.asarray(img), rng)
    want = params_from_jax(jax.device_get(p_j), jax.device_get(s_j), _mcfg())
    got = tm.data_init(_t(img), **_jax_data_init_draws(name, jm, rng, n))
    assert got and set(got) <= set(want)
    sd = tm.state_dict()
    for k, v in got.items():
        assert v.dtype == want[k].dtype and not torch.equal(v, sd[k]), k
        if k == "queue":
            _rel_close(np.sort(v.numpy(), 1), np.sort(want[k].numpy(), 1), 1e-5, k)
        else:
            _rel_close(v.numpy(), want[k].numpy(), 1e-5, k)


def _bf16_indices_match_jax(name):
    cfg, jm, params, state, tm = _pair(name, precision="bf16")
    img = np.random.RandomState(2).randn(4, RES, RES, 3).astype(np.float32)
    out_j, _ = jm.apply(params, state, jnp.asarray(img), training=False)
    out_t = tm(_t(img), training=False)
    assert np.mean(out_t["indices"].numpy() == np.asarray(out_j["indices"])) >= 0.995


def test_pqgocls_bf16_pseudo_labels_match_jax():
    _bf16_indices_match_jax("pqgo_cls_cocostuff27")


def test_new_vq_bf16_indices_match_jax():
    _bf16_indices_match_jax("new_vq_cocostuff27")


@pytest.mark.parametrize("agg_type,last_norm", [("concat", False), ("sum", True)])
def test_unseg_chain_of_quantizers_matches_jax(agg_type, last_norm):
    """Two quantizers, the second fed through ``vq_out_0``: the training
    forward's bars, and the eval forward's outputs within 1e-5."""
    cfg = micro("unseg_cocostuff27")
    cfg["model"]["vq"].update(embed_dims=[32, 32], num_codebooks=[8, 8], agg_type=agg_type)
    cfg["model"].update(hidden_dim=48, last_norm=last_norm)
    pair = _pair("unseg_cocostuff27", cfg=cfg)
    out_j, out_t = _training_forward_matches_jax("unseg_cocostuff27", pair)
    assert {"vq0-loss", "vq1-loss", "vq0-usage", "vq1-usage"} <= set(out_t["aux"])
    _, jm, params, state, tm = pair
    img = np.random.RandomState(3).randn(B, RES, RES, 3).astype(np.float32)
    ev_j, _ = jm.apply(params, state, jnp.asarray(img), training=False)
    ev_t = tm(_t(img), training=False)
    for k in ("code", "z_q"):
        _rel_close(ev_t[k].numpy(), ev_j[k], 1e-5, k)
    for got, want in zip(ev_t["feat_vqs"], ev_j["feat_vqs"]):
        _rel_close(got.numpy(), want, 1e-5, "feat_vqs")


def test_new_vq_stage1_matches_jax_given_its_kmeans_draws():
    """``model.stage: 1`` at K = 16, ``n_kmeans`` 4: JAX's k-means draws
    (``fold_in(rng, 3)``) fed to the port select the same rows for each
    centroid (their order within a centroid may differ where two distances
    agree to rounding: both sides rank an f32 product of their own); the
    training forward's bars hold (``recon-loss`` rtol 1e-5; the losses and
    gradients do not depend on the order), and each selected row's indices
    equal JAX's."""
    from equss_tpu.ops.kmeans import kmeans as jkmeans
    from test_torch_kmeans import jax_plus_plus_draws

    cfg = micro("new_vq_cocostuff27")
    cfg["model"].update(stage=1, n_kmeans=4)
    cfg["model"]["vq"]["num_codebooks"] = [16]
    cfg["eval"]["output_type"] = "feat"
    del cfg["loss"]["info_nce_weight"]       # stage 1 computes no InfoNCE
    pair = _pair("new_vq_cocostuff27", cfg=cfg)
    _, jm, params, _, _ = pair
    rs = np.random.RandomState(1)
    img, _, aug = (rs.randn(B, RES, RES, 3).astype(np.float32) for _ in range(3))
    key = jax.random.fold_in(jax.random.PRNGKey(1), 3)
    first, noise = jax_plus_plus_draws(key, 1, 2 * N, 16)
    out_j, out_t = _training_forward_matches_jax(
        "new_vq_cocostuff27", pair, kw={"kmeans_first": first, "kmeans_gumbel": noise},
        same_order=False)
    # JAX's selection, as its apply makes it
    flat = jm.features(params, jnp.concatenate([img, aug], 0)).reshape(-1, jm.feat_dim)
    cents, _ = jkmeans(key, flat, k=16, n_iters=10)
    d2 = (jnp.sum(flat * flat, -1)[None, :] + jnp.sum(cents * cents, -1)[:, None]
          - 2.0 * cents @ flat.T)
    sel_j = np.asarray(jax.lax.top_k(-d2, 4)[1])
    sel_t = out_t["selected"].numpy().reshape(16, 4)
    np.testing.assert_array_equal(np.sort(sel_t, -1), np.sort(sel_j, -1))
    by_row = lambda sel, idx: dict(zip(sel.reshape(-1).tolist(),  # noqa: E731
                                       map(tuple, np.asarray(idx).tolist())))
    assert by_row(sel_t, out_t["indices"]) == by_row(sel_j, out_j["indices"])
    assert out_t["z_q"].shape == (16 * 4, 512) and "info_nce-loss" not in out_t["aux"]


@pytest.mark.parametrize("name", ["unseg_cocostuff27", "new_vq_cocostuff27",
                                  "spq_cocostuff27"])
def test_feat_output_probes_the_code(name):
    """``eval.output_type: feat`` probes ``code``, whose width is
    ``hidden_dim`` (JAX's ``output_dim('feat')`` says ``feat_dim``: its
    probes would not take the code where the two differ, as at these
    configs' widths over vit_micro); NewVQ's stage 1 trains and validates
    through the trainer."""
    cfg = micro(name)
    cfg["num_classes"] = 4
    cfg["eval"]["output_type"] = "feat"
    if name.startswith("new_vq"):
        cfg["model"].update(stage=1, n_kmeans=4)
        cfg["model"]["vq"]["num_codebooks"] = [16]
        cfg["loss"]["info_nce_weight"] = 0.0
    tr = Trainer(cfg, device="cpu", seed=0)
    out = tr.model(torch.zeros(1, RES, RES, 3), training=False)
    assert tr.model.output_dim("feat") == out["code"].shape[-1]
    assert tr.model.output_dim("vq0") == out["z_q"].shape[-1]
    metrics = tr.train_step(_batches(1, 5)[0])
    assert metrics["skipped"] == 0.0 and np.isfinite(metrics["loss"])
    val = tr.validate(_val_batches(1, seed=6))
    assert 0.0 <= val["Cluster_mIoU"] <= 100.0


def test_spq_soft_quantize_matches_jax():
    cfg = micro("spq_cocostuff27")
    _, jm, params, _, tm = _pair("spq_cocostuff27", cfg=cfg)
    z = np.random.RandomState(4).randn(2, 3, 5, 512).astype(np.float32) * 0.05
    zq_j, soft_j = jm.soft_quantize(jnp.asarray(z), params["codebook"])
    zq_t, soft_t = tm.soft_quantize(_t(z), tm.codebook.detach())
    assert zq_t.shape == zq_j.shape and soft_t.shape == soft_j.shape == (30, 8, 2048)
    _rel_close(zq_t.numpy(), zq_j, 1e-5, "z_q")
    _rel_close(soft_t.numpy(), soft_j, 1e-5, "soft")


def test_codebook_usage_percentiles_match_jax():
    from equss_tpu.models.variants import codebook_usage_percentiles as jusage

    count = np.random.RandomState(3).poisson(2.0, (4, 64)).astype(np.float32)
    want = jusage(jnp.asarray(count), "cb")
    got = codebook_usage_percentiles(_t(count), "cb")
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-7), k


# ----------------------------------------------------------------- trainer

def _batches(n, seed, aug=False):
    out = list(synthetic_batches(seed, n, batch_size=B, res=RES, num_classes=4))
    if aug:
        rs = np.random.RandomState(seed)
        for b in out:
            b["aug_img"] = rs.randint(0, 256, b["img"].shape).astype(np.uint8)
    return out


def _trainer(name, **train):
    cfg = micro(name)
    cfg["num_classes"] = 4
    cfg["train"].update(train)
    return cfg, Trainer(cfg, device="cpu", seed=0)


def test_trainer_draws_the_view_and_a_batch_view_comes_first():
    cfg, tr = _trainer("cluster_margin_cocostuff27")
    batch = _batches(1, 0)[0]
    assert tr.apply_aug
    b = tr._batch(batch, aug=True)
    assert b["aug_img"].shape == b["img"].shape and not torch.equal(b["aug_img"], b["img"])
    given = _batches(1, 0, aug=True)[0]
    b2 = tr._batch(given, aug=True)
    assert torch.equal(b2["aug_img"], normalize_images(torch.from_numpy(given["aug_img"])))
    _, off = _trainer("cluster_margin_cocostuff27", photometric_aug=False)
    assert not off.apply_aug
    _, kw = _trainer("cluster_margin_cocostuff27", photometric_aug={"blur_p": 0.0})
    assert kw.apply_aug and kw.aug_kwargs == {"blur_p": 0.0}


def test_trainer_passes_the_draws_each_model_declares():
    """A chain of three Gumbel quantizers (deeper than any config's) gets
    all three ``gumbel_<i>`` of a batch: the forward receives them, and
    two steps on the same fixed draws agree although the trainer's
    generator moved on; without ``gumbel_2`` they differ."""
    cfg = micro("info_cocostuff27")
    cfg["num_classes"] = 4
    cfg["model"]["vq"].update(num_codebooks=[8, 8, 8], embed_dims=[32, 32, 32])
    tr = Trainer(cfg, device="cpu", seed=0)
    assert tr.model.draw_keys == ("gumbel_0", "split_noise_0", "gumbel_1", "split_noise_1",
                                  "gumbel_2", "split_noise_2")
    rs = np.random.RandomState(0)
    batch = _batches(1, 0)[0]
    batch.update({f"gumbel_{i}": rs.gumbel(size=(N, 1, 8)).astype(np.float32)
                  for i in range(3)})
    seen, forward = {}, tr.model.forward

    def recording(*args, **kwargs):
        seen.update(kwargs)
        return forward(*args, **kwargs)

    tr.model.forward = recording
    losses = [tr.forward_backward(batch)[0]["loss"].item() for _ in range(2)]
    assert torch.equal(seen["gumbel_2"], torch.from_numpy(batch["gumbel_2"]))
    assert losses[0] == losses[1]
    del batch["gumbel_2"]
    seen.clear()
    losses = [tr.forward_backward(batch)[0]["loss"].item() for _ in range(2)]
    assert "gumbel_2" not in seen and losses[0] != losses[1]


@pytest.mark.parametrize("name", CONFIGS)
def test_nonfinite_step_leaves_model_state_and_a_finite_one_moves_it(name):
    cfg, tr = _trainer(name)
    before = copy.deepcopy(tr.train_state())
    bad = _batches(1, 1)[0]
    bad["img"] = np.full(bad["img"].shape, np.nan, np.float32)
    assert tr.train_step(bad)["skipped"] == 1.0
    after = tr.train_state()
    for k, v in _flat(before).items():
        if k != "generator":
            assert torch.equal(_flat(after)[k], v), k
    metrics = tr.train_step(_batches(1, 2)[0])
    assert metrics["skipped"] == 0.0 and all(np.isfinite(v) for v in metrics.values())
    moved = {k for k, v in tr.model.state_dict().items() if not k.startswith("backbone.")
             and not torch.equal(v, before["model"][k])}
    state = {k for k, _ in tr.model.named_buffers() if not k.startswith("backbone.")}
    if name.startswith("res"):
        assert metrics["club-enc-loss"] < metrics["club-enc-loss-first"]
    if name.startswith("cluster_swav"):
        assert int(tr.model.swav_it) == 1 and int(tr.model.swav_queue_n) == 2 * N
    # every state buffer moved but the CLUB residual's, which the inner
    # likelihood does not use, and the EMA head's biases: the first step
    # averages the student's biases before its update, zero as the EMA's
    still = {k for k in state if "p_residual" in k
             or (k.startswith("ema_head.") and k.endswith(".bias"))}
    assert state - still <= moved


@pytest.mark.parametrize("name", CONFIGS)
def test_jax_train_state_converts_and_loads(name):
    cfg = micro(name)
    cfg["num_classes"] = 4
    jtr = JTrainer(cfg, mesh=make_mesh(2))
    ts = jax.device_get(jtr.init_state(jax.random.PRNGKey(0), img_hw=(RES, RES)))
    state = train_state_from_jax(ts, cfg)
    tr = Trainer(cfg, device="cpu", seed=3)
    tr.load_train_state(copy.deepcopy(state))
    mine = tr.train_state()
    for k, v in _flat(state).items():
        assert torch.equal(_flat(mine)[k], v), k
    assert set(_flat(mine)) == set(_flat(state)) | {"generator"}


def test_pqgocls_vq0_validate_matches_jax():
    _vq0_validate_matches_jax("pqgo_cls_cocostuff27")


def test_unseg_vq0_validate_matches_jax():
    _vq0_validate_matches_jax("unseg_cocostuff27")


def test_vae_vq1_validate_matches_jax():
    _vq0_validate_matches_jax("vae_cocostuff27")


def test_contra_vq0_validate_matches_jax():
    _vq0_validate_matches_jax("contra_cocostuff27")


def _vq0_validate_matches_jax(name):
    cfg = micro(name)
    cfg["num_classes"] = 4
    jtr = JTrainer(cfg, mesh=make_mesh(2))
    ts = jtr.init_state(jax.random.PRNGKey(0), img_hw=(RES, RES))
    tr = Trainer(cfg, device="cpu")
    tr.load_train_state(train_state_from_jax(jax.device_get(ts), cfg))
    val = _val_batches(2, seed=3)
    val_j, val_t = jtr.validate(ts, val), tr.validate(val)
    assert set(val_t) == set(val_j)
    for k, v in val_j.items():
        if k.endswith(("mIoU", "Accuracy")):
            assert val_t[k] == pytest.approx(v, abs=1e-6), k
        else:
            assert val_t[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    res = tr.valid_step(val[0])
    if name.startswith("pqgo"):
        assert res["pq_indices"].shape[-1] == 64


def _cli(tmp_path, config, *extra):
    before = set(glob.glob(str(tmp_path / "runs" / "*")))
    result = cli.main(["--config", f"configs/{config}.yaml", "--debug",
                       f"save_dir={tmp_path / 'runs'}", "device=cpu",
                       "model.pretrained.model_type=vit_micro", "dataset.synthetic=true",
                       "dataset.synthetic_batches=4", "dataloader.train.batch_size=2",
                       "dataloader.val.batch_size=2", "dataset.train.res=32",
                       "dataset.val.res=32", "train.max_epochs=1",
                       "train.print_interval_iters=1", "train.valid_interval_iters=2",
                       "eval.final_crf=false", *extra])
    (run_dir,) = set(glob.glob(str(tmp_path / "runs" / "*"))) - before
    return result, run_dir


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("config", ["pqgo_cls_cocostuff27", "cluster_margin_cocostuff27",
                                    "unseg_cocostuff27", "new_vq_cocostuff27",
                                    "spq_cocostuff27", "vae_cocostuff27", "info_cocostuff27",
                                    "contra_cocostuff27", "ema_cocostuff27"])
def test_cli_trains_and_validates_the_variant(tmp_path, config):
    result, run_dir = _cli(tmp_path, config)
    steps = [r for r in _records(run_dir) if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["skipped"] == 0.0 for r in steps)
    if config.startswith("unseg"):      # the per-quantizer terms are logged
        assert all(np.isfinite(r["vq0-loss"]) and "vq0-usage" in r for r in steps)
    assert 0.0 <= result["best"]["Cluster_mIoU"] <= 100.0


# each resumed config's own metric and state: the CLUB encoder, the SwAV
# queue, Contra's JSD and EMA codebooks
_RESUME_MARKS = {"res": ("club-enc-loss", "club_enc."), "cluster": ("swav-loss", "swav_queue"),
                 "contra": ("contra-loss-pos", "pq_state.")}


@pytest.mark.parametrize("config", ["res_cocostuff27", "cluster_swav_cocostuff27",
                                    "contra_cocostuff27"])
def test_cli_mid_epoch_resume_is_bit_exact(tmp_path, config):
    """``cli.run`` for 4 steps with a checkpoint at step 2, then a run
    resumed from it: the same logs after step 2 and the same weights and
    model state after step 4 (SwAV with its queue on from step 0; Contra
    with its k-means init on the fresh run's first batch and 2 micro-steps
    per update)."""
    extra = ["loss.cluster.queue_start_iter=0"] if "swav" in config else []
    result, run_dir = _cli(tmp_path, config, *extra)
    ckpt = os.path.join(run_dir, "ckpt")
    assert 2 in {int(s) for s in os.listdir(ckpt)}
    shutil.copytree(os.path.join(ckpt, "2"), tmp_path / "from2" / "2")
    resumed, resumed_dir = _cli(tmp_path, config, *extra,
                                f"resume.checkpoint={tmp_path / 'from2'}", "resume.mode=train")
    strip = lambda recs: [{k: v for k, v in r.items() if k != "iter_time"}  # noqa: E731
                          for r in recs if "final_Cluster_mIoU" not in r]
    records = _records(run_dir)
    assert strip(_records(resumed_dir)) == [r for r in strip(records) if r["step"] > 2]
    metric, state = _RESUME_MARKS[config.split("_")[0]]
    assert any(metric in r for r in records)
    assert set(resumed["state"]) == set(result["state"])
    for k, v in result["state"].items():
        assert torch.equal(resumed["state"][k], v), k
    assert any(k.startswith(state) for k in result["state"])


def test_cli_resume_of_contra_between_two_micro_steps_is_bit_exact(tmp_path):
    """Contra through ``cli.run`` (``num_accum`` 2), 4 steps, against the
    same run cut after its first step (one batch; ``train.iter_per_epoch``
    4 in both, so the schedules agree), whose checkpoint at step 1 holds
    half an update, resumed with the 4 batches: the same logs after step 1
    and the same weights and model state after step 4."""
    extra = ["train.iter_per_epoch=4"]
    result, run_dir = _cli(tmp_path, "contra_cocostuff27", *extra)
    _, cut_dir = _cli(tmp_path, "contra_cocostuff27", *extra, "dataset.synthetic_batches=1")
    ckpt = os.path.join(cut_dir, "ckpt")
    assert os.listdir(ckpt) == ["1"]
    from equss_tpu_torch.core.checkpoint import CheckpointManager
    assert CheckpointManager(ckpt).restore()["opt"]["model"]["mini_step"] == 1
    resumed, resumed_dir = _cli(tmp_path, "contra_cocostuff27", *extra,
                                f"resume.checkpoint={ckpt}", "resume.mode=train")
    strip = lambda recs: [{k: v for k, v in r.items() if k != "iter_time"}  # noqa: E731
                          for r in recs if "final_Cluster_mIoU" not in r]
    assert strip(_records(resumed_dir)) == [r for r in strip(_records(run_dir)) if r["step"] > 1]
    assert set(resumed["state"]) == set(result["state"])
    for k, v in result["state"].items():
        assert torch.equal(resumed["state"][k], v), k


def _contra_trainer_cfg():
    cfg = micro("contra_cocostuff27")
    cfg["num_classes"] = 4
    cfg["model"]["vq"]["num_codebooks"] = [16, 16]
    cfg["train"].update(max_epochs=1, iter_per_epoch=4, print_interval_iters=1,
                        valid_interval_iters=100)
    return cfg


def test_contra_resume_between_micro_steps_is_bit_exact(tmp_path):
    """Contra (``num_accum`` 2): a fresh ``fit`` of 4 steps against the
    same run saved after its first micro-step (half an update: the
    gradient mean and the micro-step count in the optimizers' state,
    through ``CheckpointManager``) and resumed by ``fit``: the same
    weights, model state and optimizer states; the parameters moved on
    steps 2 and 4 only, the EMA codebooks on every step."""
    from equss_tpu_torch.core.checkpoint import CheckpointManager

    cfg = _contra_trainer_cfg()
    batches, val = _batches(4, 7), _val_batches(1, seed=8)
    tr = Trainer(cfg, device="cpu", seed=0)
    tr.fit(lambda e: batches, lambda: val)
    cut = Trainer(cfg, device="cpu", seed=0)
    cut.data_init(batches[0])
    moves = []
    for b in batches[:2]:
        params = {k: p.detach().clone() for k, p in cut.model_params}
        ema = cut.model.pq_state[0].ema_weight.clone()
        cut.train_step(b)
        moves.append((any(not torch.equal(p, params[k]) for k, p in cut.model_params),
                      not torch.equal(cut.model.pq_state[0].ema_weight, ema)))
        if len(moves) == 1:
            assert cut.tx_model.mini_step == 1
            CheckpointManager(str(tmp_path)).save(1, cut.train_state())
    assert moves == [(False, True), (True, True)]
    resumed = Trainer(cfg, device="cpu", seed=1)
    resumed.fit(lambda e: batches, lambda: val, state=CheckpointManager(str(tmp_path)).restore())
    want, got = _flat(tr.train_state()), _flat(resumed.train_state())
    assert set(got) == set(want)
    for k, v in want.items():
        if k != "generator":
            assert torch.equal(got[k], v), k
    assert tr.tx_model.count == resumed.tx_model.count == 2


def test_fit_runs_data_init_on_a_fresh_run_only():
    """``fit`` calls ``data_init`` once, on the first batch of a fresh run
    (before the first step); a resumed ``fit`` and ``train_step`` do not."""
    cfg = _contra_trainer_cfg()
    batches, val = _batches(4, 9), _val_batches(1, seed=8)
    tr = Trainer(cfg, device="cpu", seed=0)
    calls = []
    plain = tr.model.data_init
    tr.model.data_init = lambda img, *a, **kw: calls.append(tr.step) or plain(img, *a, **kw)
    tr.train_step(batches[0])
    assert calls == []
    tr.fit(lambda e: batches, lambda: val)
    assert calls == [0]
    state = copy.deepcopy(tr.train_state())
    state["step"] = 2
    tr.fit(lambda e: batches, lambda: val, state=state)
    assert calls == [0]
