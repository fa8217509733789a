"""Whole pqgo train steps of the port vs the JAX ``Trainer``.

vit_micro, PQ 4 x 128 (d = 16), b = 2 at 64^2, dropout off, STEGO's
samples fed to both sides through the batch keys ``stego_coords1/2`` and
``stego_perms``; the JAX Trainer built as tests/test_trainer.py builds it
(a 2-device CPU mesh), its state carried into the port with
``params_from_jax``.  Two configurations:

* f32 backbone, exact PQ and correlations, the plain routes.  First-step
  gradients of the head, the codebook and both probes within 1e-4 of
  their largest magnitude; losses of both steps rtol 1e-5; parameters
  after two Adam steps within 1e-6 plus, where a gradient sits at the
  scale of Adam's eps (the first step is close to sign(g) * lr, and such
  a sign can differ), at most two learning rates.
* bf16 backbone with ``fused_ln`` on both sides and the PQ kernel route
  (``vq.use_pallas: 1``), bf16 correlations: losses rtol 2e-2 (bf16
  features rounded in another order), >= 99% of indices equal, the
  gradients' cosine similarity >= 0.99.  JAX's CPU backend cannot execute
  a bf16 x bf16 -> f32 product, so its correlation is written as f32
  products of bf16-rounded operands, the same numbers.

Also: ``chip_smoke.py``'s train configuration is the YAML preset, the
non-finite skip, and the trainer's CUDA default.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from equss_tpu.core.config import load_config
from equss_tpu.losses import stego as jstego
from equss_tpu.models.registry import build_model
from equss_tpu.models.vit import VisionTransformer as JViT
from equss_tpu.parallel.mesh import make_mesh
from equss_tpu.train.trainer import Trainer as JTrainer
from equss_tpu_torch.convert import head_from_flax, params_from_jax, probes_from_flax
from equss_tpu_torch.data.synthetic import synthetic_batches
from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig
from equss_tpu_torch.train.trainer import Trainer

LR_MODEL = 3.0e-4       # the probes' Adam runs at 3e-3


def micro_cfg(bf16: bool):
    return {
        "seed": 0, "num_classes": 4,
        "model": {
            "name": "pqgo",
            "pretrained": {"model_type": "vit_micro", "dino_patch_size": 8,
                           "freeze_backbone": True, "dropout": False, "drop_prob": 0.1,
                           "precision": "bf16" if bf16 else "f32"},
            "vq": {"vq_type": "param", "num_codebooks": [128], "embed_dims": [64],
                   "beta": 0.25, "book": 1.0, "normalize": "l2",
                   "need_initialized": "uni", "num_pq": [4],
                   "assign_precision": "bf16" if bf16 else "exact",
                   "use_pallas": 1 if bf16 else "auto"},
        },
        "loss": {"stego_weight": 1.0, "vq_weight": 1.0, "stego": {
            "neg_inter_weight": 0.63, "pos_inter_weight": 0.25, "pos_intra_weight": 0.67,
            "neg_inter_shift": 0.66, "pos_inter_shift": 0.02, "pos_intra_shift": 0.08,
            "zero_clamp": True, "pointwise": True, "stabilize": False,
            "feature_samples": 5, "neg_samples": 2,
            "correlation_precision": "bf16" if bf16 else "exact"}},
        "optimizer": {"model": {"name": "adam", "lr": LR_MODEL},
                      "cluster": {"name": "adam", "lr": 3.0e-3},
                      "linear": {"name": "adam", "lr": 3.0e-3}},
        "scheduler": {"model": {"name": "constant"}, "cluster": {"name": "constant"},
                      "linear": {"name": "constant"}},
        "eval": {"output_type": "vq0", "extra_classes": 0},
        "train": {"max_epochs": 1, "clip_grad": 10.0, "num_accum": 1},
    }


def _batches(n, seed=0):
    rng = np.random.RandomState(100 + seed)
    out = []
    for batch in synthetic_batches(seed, n, batch_size=2, res=64, num_classes=4):
        batch["stego_coords1"] = rng.uniform(-1, 1, (2, 5, 5, 2)).astype(np.float32)
        batch["stego_coords2"] = rng.uniform(-1, 1, (2, 5, 5, 2)).astype(np.float32)
        batch["stego_perms"] = np.stack([rng.permutation(2) for _ in range(2)]).astype(np.int32)
        out.append(batch)
    return out


def _jax_bf16_correlation(a, b, precision="exact"):
    if precision == "bf16":
        a = a.astype(jnp.bfloat16).astype(jnp.float32)
        b = b.astype(jnp.bfloat16).astype(jnp.float32)
    return jnp.einsum("nhwc,nijc->nhwij", a, b, precision="highest")


def _pair(bf16: bool):
    cfg = micro_cfg(bf16)
    model_j = build_model(cfg)
    if bf16:
        model_j.vit_cfg = dataclasses.replace(model_j.vit_cfg, fused_ln=True)
        model_j.backbone = JViT(model_j.vit_cfg)
    jtr = JTrainer(cfg, mesh=make_mesh(2), model=model_j)
    ts = jtr.init_state(jax.random.PRNGKey(0), img_hw=(64, 64))
    host = jax.device_get(ts)
    mcfg = dataclasses.replace(EQUSSConfig.from_config(cfg), fused_ln=bf16)
    tr = Trainer(cfg, device="cpu", model=EQUSS(mcfg, device="cpu"))
    tr.load_state_dict(params_from_jax(host["params"], host["model_state"], mcfg,
                                       probe_params=host["probe_params"]))
    return cfg, jtr, ts, tr


def _jax_grads(jtr, ts, batch):
    """JAX gradients of the step's total loss, as ``_train_step_impl``
    takes them (model: head + pq; the probes on detached z_q)."""
    b = jtr._normalize_batch({k: jnp.asarray(v) for k, v in jtr._host_trim(batch).items()})
    override = (b["stego_coords1"], b["stego_coords2"], b["stego_perms"])

    def loss_fn(tr):
        params = dict(ts["params"], **tr["model"])
        out, _ = jtr.model.apply(params, ts["model_state"], b["img"], img_pos=b["img_pos"],
                                 training=True, rng=jax.random.PRNGKey(1),
                                 stego_override=override)
        ev = jtr.evaluator.apply({"params": tr["probes"]}, jtr._select_out(out), b["label"])
        total = jtr._model_loss(out["aux"]) + ev["linear_loss"] + ev["cluster_loss"]
        return total, out["indices"]
    trainable = {"model": jtr._trainable(ts["params"]), "probes": ts["probe_params"]}
    (_, idx), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    return jax.device_get(grads), np.asarray(idx)


def _port_grads(tr):
    return {n: p.grad.clone() for n, p in
            [*tr.model_params, *((f"probes.{n}", p) for n, p in tr.probe_params)]}


def _flat_jax_grads(grads):
    """JAX gradient trees -> the port's parameter names."""
    out = {f"head.{k}": v for k, v in head_from_flax(grads["model"]["head"]).items()}
    out.update({f"pq.{k}": torch.from_numpy(np.array(v, np.float32))
                for k, v in grads["model"]["pq"].items()})
    out.update({f"probes.{k}": v for k, v in probes_from_flax(grads["probes"]).items()})
    return out


def test_train_steps_f32_match_jax_trainer():
    cfg, jtr, ts, tr = _pair(bf16=False)
    batches = _batches(2)
    grads_j, idx_j = _jax_grads(jtr, ts, batches[0])
    metrics, out = tr.forward_backward(batches[0])
    np.testing.assert_array_equal(out["indices"].numpy(), idx_j)
    got, want = _port_grads(tr), _flat_jax_grads(grads_j)
    assert set(got) == set(want)
    for k in got:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)

    for batch in batches:
        ts, m_j = jtr.train_step(ts, batch)
        m_t = tr.train_step(batch)
        for key in ("loss", "model-loss", "linear-loss", "cluster-loss", "stego-loss",
                    "vq-loss", "codebook-usage", "grad-norm"):
            assert m_t[key] == pytest.approx(float(m_j[key]), rel=1e-5, abs=1e-7), key
        assert m_t["skipped"] == float(m_j["skipped"]) == 0.0
    host = jax.device_get(ts)
    sd = params_from_jax(host["params"], host["model_state"], tr.model.cfg,
                         probe_params=host["probe_params"])
    mine = {**tr.model.state_dict(),
            **{f"probes.{k}": v for k, v in tr.evaluator.state_dict().items()}}
    for k, v in sd.items():
        if k.startswith("backbone."):
            continue
        diff = (mine[k] - v).abs()
        lr = 3.0e-3 if k.startswith("probes.") else LR_MODEL
        assert diff.max() <= 2 * lr + 1e-6, k
        assert (diff > 1e-6).float().mean() <= 0.01, k
    np.testing.assert_array_equal(tr.model.pq_state.vq_count.numpy(),
                                  sd["pq_state.vq_count"].numpy())


def test_train_steps_bf16_fused_ln_kernel_route_match_jax_trainer(monkeypatch):
    monkeypatch.setattr(jstego, "tensor_correlation", _jax_bf16_correlation)
    cfg, jtr, ts, tr = _pair(bf16=True)
    batches = _batches(2, seed=1)
    grads_j, idx_j = _jax_grads(jtr, ts, batches[0])
    metrics, out = tr.forward_backward(batches[0])
    assert np.mean(out["indices"].numpy() == idx_j) >= 0.99
    got, want = _port_grads(tr), _flat_jax_grads(grads_j)
    for k in ("head.cluster1.weight", "head.cluster2_fc2.weight", "pq.codebook"):
        a, b = got[k].flatten(), want[k].flatten()
        assert torch.nn.functional.cosine_similarity(a, b, dim=0) >= 0.99, k
    for batch in batches:
        ts, m_j = jtr.train_step(ts, batch)
        m_t = tr.train_step(batch)
        for key in ("loss", "stego-loss", "vq-loss", "linear-loss", "cluster-loss"):
            assert m_t[key] == pytest.approx(float(m_j[key]), rel=2e-2, abs=1e-4), key


def test_chip_smoke_train_config_is_the_yaml_preset():
    import chip_smoke

    yaml_cfg = load_config("configs/pqgo_cocostuff27.yaml")
    assert chip_smoke.PQGO_COCOSTUFF27 == yaml_cfg
    kernel = chip_smoke.train_config("kernel")
    assert kernel["model"]["vq"].pop("use_pallas") == 1
    assert kernel == yaml_cfg
    assert chip_smoke.train_config("stock") == yaml_cfg


def test_nonfinite_step_changes_nothing():
    cfg = micro_cfg(bf16=False)
    tr = Trainer(cfg, device="cpu")
    batch = _batches(1)[0]
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    probes = {k: v.clone() for k, v in tr.evaluator.state_dict().items()}
    bad = dict(batch, img=np.full_like(batch["img"], np.nan))
    m = tr.train_step(bad)
    assert m["skipped"] == 1.0 and not np.isfinite(m["loss"])
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k            # vq_count included
    for k, v in tr.evaluator.state_dict().items():
        assert torch.equal(v, probes[k]), k
    assert all(not s for s in tr.tx_model.opt.state.values())
    m = tr.train_step(batch)
    assert m["skipped"] == 0.0
    assert tr.model.pq_state.vq_count.sum() == 4 * 2 * 8 * 8    # M x pixels


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(micro_cfg(bf16=False))
    bad = copy.deepcopy(micro_cfg(bf16=False))
    bad["model"]["vq"]["vq_type"] = "ema"
    bad["model"]["vq"]["normalize"] = "none"
    bad["model"]["vq"]["use_restart"] = True           # EMA trains; restart is later
    tr = Trainer(bad, device="cpu")
    with pytest.raises(NotImplementedError, match="use_restart"):
        tr.train_step(_batches(1)[0])


def test_loss_weight_without_aux_key_raises():
    """A configured loss weight whose aux key the model never emits is a
    config error, not a loss silently left out."""
    cfg = micro_cfg(bf16=False)
    cfg["loss"]["jsd_weight"] = 0.5
    tr = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="jsd"):
        tr.train_step(_batches(1)[0])
