"""The port's training modules vs the JAX package, module by module.

Same inputs from a numpy seed on both sides; every JAX Pallas kernel runs
in interpret mode.

* ``pq_forward(training=True)``, f32 exact, on the plain route (JAX's XLA
  path) and the kernel route (``AssignSTE`` vs ``_pallas_assign_ste``):
  indices, ``vq_count`` and the usage telemetry equal; z_q within 1e-6;
  vq-loss rtol 1e-5; gradients of z, the codebook (and the z_trainable
  statistics) within 1e-5 of their largest magnitude (f32 sums in another
  order).
* bf16 fast mode: >= 99% of indices equal (distances rounded to bf16 tie
  and their f32 sums run in another order); the rest is compared where
  the indices agree.  On the kernel route everything is held against
  ``_pallas_assign_ste``.  JAX's CPU backend cannot execute a bf16 x bf16
  -> f32 product, which the XLA path's bf16 distances and one-hot gather
  are, so the plain route is held against a numpy oracle of its
  assignment and its gradients against the same chain written in JAX
  with f32 products at the port's own indices: the codeword gradient is
  the f32 scatter-add, rounded to bf16 by the cast.
* ``stego_loss`` with the sample override: loss rtol 1e-5 in f32 and
  2e-3 with bf16 correlations; code gradients within 1e-4 (f32) and 1e-2
  (bf16) of their largest magnitude, on both of grid_sample's routes
  (the bilinear-weight matmul and the gather form, ``F.grid_sample`` in
  the port, whose weights associate differently).  For the bf16 case the JAX correlation
  is written as f32 products of bf16-rounded operands, for the same
  reason.
* ``Evaluator``: losses rtol 1e-5, predictions equal, probe gradients
  within 1e-5 of their largest magnitude.
* ``build_optimizer`` against the optax chains of ``equss_tpu.train.
  optim`` over three steps: parameters within 1e-6 (adam, adamw with its
  decay mask, sgd with momentum and decay, cosine schedule, clipping);
  gradient accumulation against ``optax.MultiSteps`` over 4 micro-steps.
* The quantizer's training features given JAX's draws: the Gumbel
  assignment (indices equal away from rounding-level near ties, the EMA
  state within 1e-5 of its scale), ``_split_codes`` (codebook and counts
  equal, with ties at zero), the EMA step with ``use_split``, the
  ``want_prob`` rule, and ``pq_data_init`` for ``kmeans`` and ``rand``
  (within 1e-5 of scale).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from equss_tpu.losses import stego as jstego
from equss_tpu.ops import quantizer as jq
from equss_tpu_torch.convert import probes_from_flax
from equss_tpu_torch.losses import stego as tstego
from equss_tpu_torch.ops import launch_counts
from equss_tpu_torch.ops import quantizer as tq


def _close_to_max(got, want, frac):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max())


# ------------------------------------------------------------------ PQ

def _pq_case(normalize, use_pallas, precision, seed):
    base = dict(num_pq=4, num_codebook=128, embed_dim=64, vq_type="param",
                normalize=normalize, use_pallas=use_pallas, assign_precision=precision)
    cfg_j, cfg_t = jq.PQConfig(**base), tq.PQConfig(**base)
    params, state = jq.pq_init(jax.random.PRNGKey(seed), cfg_j)
    rng = np.random.RandomState(seed)
    params = {k: np.array(v) for k, v in params.items()}
    # a codebook on the data's scale, so many codewords are used
    params["codebook"] = rng.randn(*params["codebook"].shape).astype(np.float32)
    if normalize == "z_trainable":
        params["z_mean"] = (0.1 * rng.randn(*params["z_mean"].shape)).astype(np.float32)
        params["z_log_var"] = (0.1 * rng.randn(*params["z_log_var"].shape)).astype(np.float32)
    state = {k: (np.abs(rng.randn(*np.shape(v))) * 3).astype(np.float32)
             for k, v in state.items()}
    z = rng.randn(2, 6, 5, 64).astype(np.float32)
    w = rng.randn(2, 6, 5, 64).astype(np.float32)            # z_q cotangent
    return cfg_j, cfg_t, params, state, z, w


def _jax_pq(cfg, params, state, z, w, fixed_indices=None):
    """JAX forward outputs and d(vq-loss + sum(z_q * w)) w.r.t. z and the
    params.  ``fixed_indices``: the bf16 plain route's oracle (see the
    module docstring)."""
    def loss(z, p):
        if fixed_indices is None:
            zq, idx, aux, st = jq.pq_forward(z, p, state, cfg, training=True)
            return aux["vq-loss"] + jnp.sum(zq * w), (zq, idx, aux, st)
        M, d = cfg.num_pq, cfg.sub_dim
        zn = jq.normalize_vectors(z.reshape(-1, M, d), cfg.normalize)
        src = p["codebook"].astype(jnp.bfloat16).astype(jnp.float32)
        zq = jq._gather_codewords(src, fixed_indices.reshape(-1, M))
        vq = cfg.book * jnp.mean((zq - jax.lax.stop_gradient(zn)) ** 2) \
            + cfg.beta * jnp.mean((zn - jax.lax.stop_gradient(zq)) ** 2)
        zst = zn + jax.lax.stop_gradient(zq - zn)
        return vq + jnp.sum(zst.reshape(z.shape) * w), None
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), {k: jnp.asarray(v) for k, v in params.items()})
    return out, grads


def _port_pq(cfg, params, state, z, w):
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    zt = torch.from_numpy(z).requires_grad_()
    zq, idx, aux, new_state = tq.pq_forward(zt, pt, st, cfg, training=True)
    (aux["vq-loss"] + (zq * torch.from_numpy(w)).sum()).backward()
    assert new_state is not st and torch.equal(st["vq_count"],
                                                torch.from_numpy(state["vq_count"]))
    return zq, idx, aux, new_state, zt.grad, {k: v.grad for k, v in pt.items()}


@pytest.mark.parametrize("normalize,use_pallas", [
    ("l2", False), ("z_norm", False), ("z_trainable", False), ("none", False),
    ("l2", True), ("z_norm", True), ("none", True),
], ids=lambda v: str(v))
def test_pq_forward_training_exact_matches_jax(normalize, use_pallas):
    cfg_j, cfg_t, params, state, z, w = _pq_case(normalize, use_pallas, "exact", seed=3)
    (zq_j, idx_j, aux_j, st_j), (gz_j, gp_j) = _jax_pq(cfg_j, params, state, z, w)
    before = launch_counts()["pq_assign"]
    zq, idx, aux, st, gz, gp = _port_pq(cfg_t, params, state, z, w)
    assert launch_counts()["pq_assign"] == before          # CPU: the plain versions
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(zq.detach().numpy(), np.asarray(zq_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(st["vq_count"].numpy(), np.asarray(st_j["vq_count"]))
    for key in ("codebook-usage", "current-p10", "current-p50", "current-p90"):
        assert float(aux[key]) == pytest.approx(float(aux_j[key]), rel=1e-6), key
    assert float(aux["vq-loss"].detach()) == pytest.approx(float(aux_j["vq-loss"]), rel=1e-5)
    _close_to_max(gz, gz_j, 1e-5)
    assert set(gp) == set(gp_j)
    for k in gp:
        _close_to_max(gp[k], gp_j[k], 1e-5)


def _bf16_oracle_indices(z, codebook, cfg):
    """The bf16 XLA path's assignment, in numpy: dist = bf16(z_sq + c_sq -
    2 cross) of bf16 operands, first minimum (JAX's CPU backend cannot
    execute that path's bf16 x bf16 -> f32 products)."""
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    M, d = cfg.num_pq, cfg.sub_dim
    zf = z.reshape(-1, M, d)
    zn = zf / np.maximum(np.linalg.norm(zf, axis=-1, keepdims=True), 1e-12)
    cn = codebook / np.maximum(np.linalg.norm(codebook, axis=-1, keepdims=True), 1e-12)
    zb, cbn = bf(zn), bf(cn)
    dist = bf((bf(zb * zb).sum(-1)[:, :, None] + bf(cbn * cbn).sum(-1)[None])
              - 2.0 * np.einsum("nmd,mkd->nmk", zb, cbn))
    return dist.argmin(-1).reshape(*z.shape[:-1], M)


def test_pq_forward_training_bf16_kernel_route_matches_jax():
    cfg_j, cfg_t, params, state, z, w = _pq_case("l2", True, "bf16", seed=4)
    (zq_j, idx_j, aux_j, st_j), (gz_j, gp_j) = _jax_pq(cfg_j, params, state, z, w)
    zq, idx, aux, st, gz, gp = _port_pq(cfg_t, params, state, z, w)
    same = idx.numpy() == np.asarray(idx_j)
    assert same.mean() >= 0.99, same.mean()
    M, K, d = cfg_t.num_pq, cfg_t.num_codebook, cfg_t.sub_dim
    zq4 = zq.detach().numpy().reshape(*same.shape, d)
    np.testing.assert_allclose(zq4[same], np.asarray(zq_j).reshape(*same.shape, d)[same],
                               rtol=0, atol=1e-6)
    # counts move by at most one per disagreeing assignment, on each side
    dc = np.abs(st["vq_count"].numpy() - np.asarray(st_j["vq_count"]))
    assert dc.sum() <= 2 * (~same).sum()
    # gradients where no disagreeing assignment reaches them
    agree_px = same.reshape(-1, M)
    gz_t = gz.numpy().reshape(-1, M, d)
    gz_r = np.asarray(gz_j).reshape(-1, M, d)
    np.testing.assert_allclose(gz_t[agree_px], gz_r[agree_px], rtol=0,
                               atol=1e-5 * np.abs(gz_r).max())
    touched = np.zeros((M, K), bool)
    for n, m in zip(*np.nonzero(~agree_px)):
        touched[m, idx.numpy().reshape(-1, M)[n, m]] = True
        touched[m, np.asarray(idx_j).reshape(-1, M)[n, m]] = True
    gc_t, gc_r = gp["codebook"].numpy(), np.asarray(gp_j["codebook"])
    np.testing.assert_allclose(gc_t[~touched], gc_r[~touched], rtol=0,
                               atol=1e-5 * np.abs(gc_r).max())


def test_pq_forward_training_bf16_plain_route_matches_oracle():
    cfg_j, cfg_t, params, state, z, w = _pq_case("l2", False, "bf16", seed=5)
    zq, idx, aux, st, gz, gp = _port_pq(cfg_t, params, state, z, w)
    idx_o = _bf16_oracle_indices(z, params["codebook"], cfg_t)
    assert np.mean(idx.numpy() == idx_o) >= 0.99
    M, K, d = cfg_t.num_pq, cfg_t.num_codebook, cfg_t.sub_dim
    own = idx.numpy().reshape(-1, M)
    cb16 = np.asarray(jnp.asarray(params["codebook"]).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_allclose(zq.detach().numpy().reshape(-1, M, d),
                               cb16[np.arange(M), own], rtol=0, atol=1e-6)
    count = np.stack([np.bincount(own[:, m], minlength=K)
                      for m in range(M)]).astype(np.float32)
    np.testing.assert_array_equal(st["vq_count"].numpy(), state["vq_count"] + count)
    for key, val in jq._usage_aux(jnp.asarray(count, jnp.float32), K).items():
        assert float(aux[key]) == pytest.approx(float(val), rel=1e-6), key
    # gradients: the JAX chain at the port's own indices
    _, (gz_j, gp_j) = _jax_pq(cfg_j, params, state, z, w,
                              fixed_indices=jnp.asarray(idx.numpy()))
    _close_to_max(gz, gz_j, 1e-5)
    _close_to_max(gp["codebook"], gp_j["codebook"], 1e-5)


def test_assign_ste_backward_definition():
    """The kernel route's backward, held to its definition: d codebook is
    the scatter-add of d z_q at the indices, d z the normalize VJP."""
    g = torch.Generator().manual_seed(0)
    z = torch.randn((50, 3, 16), generator=g, requires_grad=True)
    cb = torch.randn((3, 128, 16), generator=g, requires_grad=True)
    cn = tq.normalize_vectors(cb, "l2")
    idx, zn, zq = tq.AssignSTE.apply(z, cb, cn, "l2", True)
    gzn, gzq = torch.randn(zn.shape, generator=g), torch.randn(zq.shape, generator=g)
    torch.autograd.backward((zn, zq), (gzn, gzq))
    want = torch.zeros_like(cb)
    for n in range(50):
        for m in range(3):
            want[m, idx[n, m]] += gzq[n, m]
    torch.testing.assert_close(cb.grad, want, rtol=1e-6, atol=1e-6)
    zz = z.detach().requires_grad_()
    (want_z,) = torch.autograd.grad(tq.normalize_vectors(zz, "l2"), zz, gzn)
    torch.testing.assert_close(z.grad, want_z, rtol=0, atol=0)


# --------------------------------------------------------------- STEGO

def _jax_bf16_correlation(a, b, precision="exact"):
    """JAX's bf16 correlation (bf16 operands, f32 sums) as f32 products of
    the rounded operands: the CPU backend cannot execute its bf16 x bf16
    -> f32 einsum.  The casts keep their gradient rounding."""
    if precision == "bf16":
        a = a.astype(jnp.bfloat16).astype(jnp.float32)
        b = b.astype(jnp.bfloat16).astype(jnp.float32)
    return jnp.einsum("nhwc,nijc->nhwij", a, b, precision="highest")


@pytest.mark.parametrize("route", ["matmul", "gather"])
@pytest.mark.parametrize("precision", ["exact", "bf16"])
def test_stego_loss_with_override_matches_jax(precision, route, monkeypatch):
    monkeypatch.setattr(jstego, "tensor_correlation", _jax_bf16_correlation)
    if route == "gather":        # both sides off the bilinear-weight matmul
        for mod in (jstego, tstego):
            monkeypatch.setattr(mod, "_MATMUL_MAX_QHW", 0)
    cfg_j = jstego.StegoLossConfig(feature_samples=5, neg_samples=3,
                                   correlation_precision=precision)
    cfg_t = tstego.StegoLossConfig(**dataclasses.asdict(cfg_j))
    rng = np.random.RandomState(7)
    b = 3
    feats, feats_pos = (rng.randn(b, 7, 6, 24).astype(np.float32) for _ in range(2))
    code, code_pos = (rng.randn(b, 7, 6, 40).astype(np.float32) for _ in range(2))
    c1, c2 = (rng.uniform(-1.1, 1.1, (b, 5, 5, 2)).astype(np.float32) for _ in range(2))
    perms = np.stack([rng.permutation(b) for _ in range(3)]).astype(np.int32)

    def loss_j(c, cp):
        return jstego.stego_loss(jax.random.PRNGKey(0), jnp.asarray(feats),
                                 jnp.asarray(feats_pos), c, cp, cfg_j,
                                 sample_override=(jnp.asarray(c1), jnp.asarray(c2),
                                                  jnp.asarray(perms)))
    ref, (g_j, gp_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jnp.asarray(code), jnp.asarray(code_pos))
    ct, cpt = (torch.from_numpy(x).requires_grad_() for x in (code, code_pos))
    out = tstego.stego_loss(None, torch.from_numpy(feats), torch.from_numpy(feats_pos),
                            ct, cpt, cfg_t, sample_override=(
                                torch.from_numpy(c1), torch.from_numpy(c2),
                                torch.from_numpy(perms)))
    out.backward()
    exact = precision == "exact"
    assert float(out) == pytest.approx(float(ref), rel=1e-5 if exact else 2e-3)
    _close_to_max(ct.grad, g_j, 1e-4 if exact else 1e-2)
    _close_to_max(cpt.grad, gp_j, 1e-4 if exact else 1e-2)


@pytest.mark.parametrize("route", ["matmul", "gather"])
def test_grid_sample_matches_jax(route, monkeypatch):
    """Both routes against the JAX package's grid_sample (border padding,
    align_corners=True), coordinates reaching past the border: within
    1e-5 (the corner weights associate differently)."""
    if route == "gather":
        for mod in (jstego, tstego):
            monkeypatch.setattr(mod, "_MATMUL_MAX_QHW", 0)
    rng = np.random.RandomState(9)
    t = rng.randn(3, 7, 9, 5).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (3, 4, 6, 2)).astype(np.float32)
    ref = np.asarray(jstego.grid_sample(jnp.asarray(t), jnp.asarray(coords)))
    out = tstego.grid_sample(torch.from_numpy(t), torch.from_numpy(coords))
    assert out.shape == (3, 4, 6, 5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_stego_random_draws_and_super_perm():
    g = torch.Generator().manual_seed(0)
    for size in (2, 5, 16):
        for _ in range(20):
            p = tstego.super_perm(g, size, "cpu")       # shifted fixed points
            assert ((p >= 0) & (p < size)).all()
            assert not (p == torch.arange(size)).any()
    x = torch.randn(4, 6, 6, 8, generator=g)
    loss = tstego.stego_loss(g, x, x.flip(0), x, x.flip(0), tstego.StegoLossConfig(
        feature_samples=3, neg_samples=2))
    assert torch.isfinite(loss)


# -------------------------------------------------------------- probes

def test_evaluator_losses_and_gradients_match_jax():
    from equss_tpu.eval.probes import Evaluator as JEvaluator
    from equss_tpu.eval.probes import EvaluatorConfig as JCfg
    from equss_tpu_torch.eval.probes import Evaluator, EvaluatorConfig

    rng = np.random.RandomState(2)
    feats = rng.randn(2, 8, 8, 32).astype(np.float32)
    label = rng.randint(-1, 5, (2, 64, 64)).astype(np.int32)   # -1 and 4 ignored
    cfg = dict(embed_dim=32, num_classes=4, extra_classes=1)
    ev_j = JEvaluator(JCfg(**cfg))
    params = ev_j.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(label))["params"]

    def loss_j(p):
        r = ev_j.apply({"params": p}, jnp.asarray(feats), jnp.asarray(label))
        return r["linear_loss"] + r["cluster_loss"], r
    (_, res_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)

    ev = Evaluator(EvaluatorConfig(**cfg), torch.Generator().manual_seed(0))
    ev.load_state_dict(probes_from_flax(params))
    res = ev(torch.from_numpy(feats), torch.from_numpy(label))
    (res["linear_loss"] + res["cluster_loss"]).backward()
    for key in ("linear_loss", "cluster_loss"):
        assert float(res[key]) == pytest.approx(float(res_j[key]), rel=1e-5), key
    for key in ("linear_preds", "cluster_preds"):
        np.testing.assert_array_equal(res[key].numpy(), np.asarray(res_j[key]))
    grads = {k: v.grad for k, v in ev.named_parameters()}
    want = probes_from_flax(g_j)
    assert set(grads) == set(want)
    for k in grads:
        _close_to_max(grads[k], want[k], 1e-5)


# ---------------------------------------------------------- optimizers

@pytest.mark.parametrize("opt_cfg,sched_cfg,clip", [
    ({"name": "adam", "lr": 3e-3}, {"name": "constant"}, 10.0),
    ({"name": "adam", "lr": 3e-3}, {"name": "cos", "min_lr": 1e-4}, 0.5),
    ({"name": "adamw", "lr": 1e-2, "weight_decay": 0.1, "betas": (0.8, 0.95)},
     {"name": "constant", "factor": 0.5}, None),
    ({"name": "sgd", "lr": 1e-2, "weight_decay": 0.05}, {"name": "cos"}, 1.0),
], ids=["adam-clip", "adam-cos-clipped", "adamw-mask", "sgd-cos-clip"])
def test_optimizer_matches_optax(opt_cfg, sched_cfg, clip):
    import optax

    from equss_tpu.train.optim import build_optimizer as j_build
    from equss_tpu.train.optim import global_grad_norm as j_norm
    from equss_tpu_torch.train.optim import build_optimizer, global_grad_norm

    rng = np.random.RandomState(0)
    shapes = {"head.w": (4, 3), "head.b": (3,), "pq.codebook": (2, 3, 4)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tree = lambda flat: {"head": {"w": flat["head.w"], "b": flat["head.b"]},  # noqa: E731
                         "pq": {"codebook": flat["pq.codebook"]}}
    kw = dict(iter_per_epoch=2, max_epochs=2, clip_grad=clip)
    tx = j_build(opt_cfg, sched_cfg, **kw)
    pj = tree({k: jnp.asarray(v) for k, v in init.items()})
    state = tx.init(pj)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()))) for k, v in init.items()]
    opt = build_optimizer(named, opt_cfg, sched_cfg, **kw)
    for _ in range(3):
        grads = {k: (3 * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
        gj = tree({k: jnp.asarray(v) for k, v in grads.items()})
        for k, p in named:
            p.grad = torch.from_numpy(grads[k].copy())
        assert float(global_grad_norm(p for _, p in named)) == pytest.approx(
            float(j_norm(gj)), rel=1e-6)
        updates, state = tx.update(gj, state, pj)
        pj = optax.apply_updates(pj, updates)
        opt.step()
        flat_j = {"head.w": pj["head"]["w"], "head.b": pj["head"]["b"],
                  "pq.codebook": pj["pq"]["codebook"]}
        for k, p in named:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(flat_j[k]),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_optimizer_rejects_accumulation_and_unknown_names():
    """Gradient accumulation is optax's ``MultiSteps`` (it no longer
    raises): 4 micro-steps at ``num_accum`` 2 with clipping and a cosine
    schedule against ``MultiSteps(chain(clip, adamw))``, parameters within
    1e-6 after each, unchanged after the first of each pair, and the
    state's micro-step and gradient mean equal; an unknown optimizer name
    still raises."""
    import optax

    from equss_tpu.train.optim import build_optimizer as j_build
    from equss_tpu_torch.train.optim import build_optimizer, wd_mask

    rng = np.random.RandomState(1)
    shapes = {"head.w": (4, 3), "head.b": (3,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    opt_cfg = {"name": "adamw", "lr": 1e-2, "weight_decay": 0.1}
    kw = dict(iter_per_epoch=4, max_epochs=2, num_accum=2, clip_grad=0.5)
    tx = j_build(opt_cfg, {"name": "cos"}, **kw)
    assert isinstance(tx, optax.MultiSteps)
    pj = {"head": {"w": jnp.asarray(init["head.w"]), "b": jnp.asarray(init["head.b"])}}
    state = tx.init(pj)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()))) for k, v in init.items()]
    opt = build_optimizer(named, opt_cfg, {"name": "cos"}, **kw)
    for i in range(4):
        grads = {k: (3 * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
        before = {k: p.detach().clone() for k, p in named}
        for k, p in named:
            p.grad = torch.from_numpy(grads[k].copy())
        updates, state = tx.update({"head": {"w": jnp.asarray(grads["head.w"]),
                                             "b": jnp.asarray(grads["head.b"])}}, state, pj)
        pj = optax.apply_updates(pj, updates)
        opt.step()
        for k, p in named:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj["head"][k[5:]]),
                                       rtol=0, atol=1e-6, err_msg=k)
            assert torch.equal(p.detach(), before[k]) == (i % 2 == 0), (i, k)
        sd = opt.state_dict()
        assert sd["mini_step"] == int(state.mini_step) and sd["count"] == int(state.gradient_step)
        for k in shapes:
            np.testing.assert_allclose(sd["acc"][k].numpy(),
                                       np.asarray(state.acc_grads["head"][k[5:]]),
                                       rtol=0, atol=1e-6)
    p = [("head.w", torch.nn.Parameter(torch.zeros(2, 2)))]
    with pytest.raises(ValueError):
        build_optimizer(p, {"name": "lamb", "lr": 1.0})
    assert wd_mask("head.w", torch.zeros(2, 2))
    assert not wd_mask("head.b", torch.zeros(2))
    assert not wd_mask("pq.codebook", torch.zeros(2, 2, 2))


# ------------------------------------------- quantizer training features

def _ema_case(seed, **kw):
    """An EMA quantizer (M = 2, K = 24, d = 8, l2) with a codebook on the
    data's scale and state of a few steps' standing, z (3, 5, 4, 16)."""
    base = dict(num_pq=2, num_codebook=24, embed_dim=16, vq_type="ema", normalize="l2", **kw)
    cfg_j, cfg_t = jq.PQConfig(**base), tq.PQConfig(**base)
    rng = np.random.RandomState(seed)
    _, state = jq.pq_init(jax.random.PRNGKey(seed), cfg_j)
    state = {k: np.array(v) for k, v in state.items()}
    cb = rng.randn(2, 24, 8).astype(np.float32)
    state.update(ema_weight=cb, ema_weight_avg=cb * 1.5,
                 ema_count=(np.abs(rng.randn(2, 24)) * 3).astype(np.float32))
    z = rng.randn(3, 5, 4, 16).astype(np.float32)
    return cfg_j, cfg_t, state, z


def _state_close(got, want):
    assert set(got) == set(want)
    for k in want:
        _close_to_max(got[k], want[k], 1e-5)


def test_gumbel_assignment_matches_jax_given_its_noise():
    """``use_gumbel`` training: given JAX's Gumbel draw the indices equal
    JAX's wherever its top two of ``g - dist`` are more than 1e-5 apart
    (all but rounding-level near ties), and the counts, usage and EMA
    state follow them; z_q is the raw codeword; the eval call and a
    ``want_prob=False`` call keep the argmin, and ``use_gumbel`` keeps
    even the eval call off the kernel on CUDA, as JAX does."""
    cfg_j, cfg_t, state, z = _ema_case(5, use_gumbel=True)
    key = jax.random.PRNGKey(9)
    n = 3 * 5 * 4
    g = np.array(jax.random.gumbel(jax.random.split(key)[1], (n, 2, 24)))
    zq_j, idx_j, aux_j, st_j = jq.pq_forward(jnp.asarray(z), {}, state, cfg_j, training=True,
                                            rng=key)
    st_t = {k: torch.from_numpy(v) for k, v in state.items()}
    zq_t, idx_t, aux_t, new_t = tq.pq_forward(torch.from_numpy(z), {}, st_t, cfg_t,
                                              training=True, gumbel_noise=torch.from_numpy(g))
    zn = z.reshape(n, 2, 8) / np.linalg.norm(z.reshape(n, 2, 8), axis=-1, keepdims=True)
    cn = state["ema_weight"] / np.linalg.norm(state["ema_weight"], axis=-1, keepdims=True)
    score = g - ((zn[:, :, None] - cn[None]) ** 2).sum(-1)
    two = np.sort(score, -1)[..., -2:]
    apart = (two[..., 1] - two[..., 0] > 1e-5).reshape(3, 5, 4, 2)
    assert apart.mean() > 0.95
    np.testing.assert_array_equal(idx_t.numpy()[apart], np.asarray(idx_j)[apart])
    # the argmin of the distances alone would differ in most pairs
    plain = tq.pq_forward(torch.from_numpy(z), {}, st_t, cfg_t)[1]
    assert (plain.numpy() != idx_t.numpy()).mean() > 0.5
    assert apart.all()                  # this draw has no near tie: the rest follows
    _state_close(new_t, st_j)
    np.testing.assert_allclose(zq_t.detach().numpy(), np.asarray(zq_j), rtol=0, atol=1e-6)
    for k in ("vq-loss", "codebook-usage"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=1e-5), k
    assert tq._kernel_eligible(dataclasses.replace(cfg_t, use_gumbel=False, use_pallas=True),
                               10, torch.device("cuda"))
    assert not tq._kernel_eligible(dataclasses.replace(cfg_t, use_pallas=True), 10,
                                   torch.device("cuda"))
    with pytest.raises(ValueError, match="use_gumbel requires"):
        tq.pq_forward(torch.from_numpy(z), {}, st_t, cfg_t, training=True)
    gen = torch.Generator().manual_seed(0)
    assert tq.pq_forward(torch.from_numpy(z), {}, st_t, cfg_t, training=True,
                         generator=gen)[1].shape == (3, 5, 4, 2)


def test_split_codes_matches_jax_with_ties_at_zero():
    """``_split_codes`` given JAX's noise: a count table whose dead slots
    tie at 0 (the stable sort keeps their index order) and whose live
    counts tie in pairs; the codebook and counts equal."""
    rng = np.random.RandomState(2)
    M, K, d = 3, 16, 4
    codebook = rng.randn(M, K, d).astype(np.float32)
    total = np.zeros((M, K), np.float32)
    total[:, ::3] = np.repeat(np.arange(1, 7, dtype=np.float32), 2)[None, :6] * 0.5
    total[1, 5] = 2.0
    current = total.copy()
    current[2, 0] = 0.0                      # dead in this batch, used before
    key = jax.random.PRNGKey(4)
    want_c, want_n = jq._split_codes(key, jnp.asarray(codebook), jnp.asarray(total),
                                     jnp.asarray(current))
    noise = np.array(jax.random.normal(key, (M, K, d)))
    got_c, got_n = tq.split_codes(torch.from_numpy(codebook), torch.from_numpy(total),
                                  torch.from_numpy(current), torch.from_numpy(noise))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-6)
    assert (got_c.numpy() != codebook).any(-1).sum() > M * K // 2


def test_ema_split_training_step_matches_jax():
    """``use_split`` inside ``pq_forward`` (after the EMA update), the
    split's noise JAX's ``normal(split(rng)[1])``: the new EMA state within
    1e-5 of its scale; ``want_prob=False`` drops the distance softmax of
    EMA training and ``True`` adds it in eval, as JAX's rule."""
    cfg_j, cfg_t, state, z = _ema_case(6, use_split=True)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(jax.random.split(key)[1], (2, 24, 8)))
    _, idx_j, aux_j, st_j = jq.pq_forward(jnp.asarray(z), {}, state, cfg_j, training=True,
                                          rng=key)
    st_t = {k: torch.from_numpy(v) for k, v in state.items()}
    _, idx_t, aux_t, new_t = tq.pq_forward(torch.from_numpy(z), {}, st_t, cfg_t, training=True,
                                           split_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _state_close(new_t, st_j)
    _close_to_max(aux_t["distance_prob"], aux_j["distance_prob"], 1e-5)
    no_prob = tq.pq_forward(torch.from_numpy(z), {}, st_t, cfg_t, training=True,
                            want_prob=False, split_noise=torch.from_numpy(noise))[2]
    assert "distance_prob" not in no_prob
    ev_j = jq.pq_forward(jnp.asarray(z), {}, state, cfg_j, want_prob=True)[2]
    ev_t = tq.pq_forward(torch.from_numpy(z), {}, st_t, cfg_t, want_prob=True)[2]
    _close_to_max(ev_t["distance_prob"], ev_j["distance_prob"], 1e-5)
    # the effective want_prob routes: an EMA training call without the
    # softmax may take the kernel on CUDA only where training may
    ema = dataclasses.replace(cfg_t, use_split=False, use_pallas=True)
    assert not tq._kernel_eligible(ema, 10, torch.device("cuda"), training=True)
    assert tq._kernel_eligible(ema, 10, torch.device("cuda"), want_prob=False)
    assert not tq._kernel_eligible(ema, 10, torch.device("cuda"), want_prob=True)


@pytest.mark.parametrize("mode,vq_type", [("kmeans", "ema"), ("kmeans", "param"),
                                          ("rand", "ema"), ("rand", "param")])
def test_pq_data_init_matches_jax_given_its_draws(mode, vq_type):
    """``pq_data_init`` with JAX's draws (k-means++ ``randint`` / ``gumbel``
    for ``kmeans``, ``randint(key, (M, K), 0, n)`` for ``rand``): the new
    codebook (or ``ema_weight`` and ``ema_weight_avg``) within 1e-5 of its
    scale, the counts untouched; ``pq_init`` no longer raises for either
    mode and draws the default uniform init."""
    from test_torch_kmeans import _blobs, jax_plus_plus_draws

    M, K, d, n = 2, 12, 8, 300
    base = dict(num_pq=M, num_codebook=K, embed_dim=M * d, vq_type=vq_type,
                need_initialized=mode)
    cfg_j, cfg_t = jq.PQConfig(**base), tq.PQConfig(**base)
    pj, sj = jq.pq_init(jax.random.PRNGKey(0), cfg_j)
    pt, st = tq.pq_init(torch.Generator().manual_seed(0), cfg_t)
    cb = (pt.get("codebook") if vq_type == "param" else st["ema_weight"])
    assert float(cb.abs().max()) <= 1.0 / K
    zf = _blobs(5, M, n, d).transpose(1, 0, 2).copy()                  # (n, M, d)
    key = jax.random.PRNGKey(11)
    want_p, want_s = jq.pq_data_init(key, jnp.asarray(zf), pj, sj, cfg_j)
    if mode == "kmeans":
        first, noise = jax_plus_plus_draws(key, M, n, K)
        draws = dict(first=first, gumbel_noise=noise)
    else:
        draws = dict(rand_idx=torch.from_numpy(np.array(
            jax.random.randint(key, (M, K), 0, n))))
    got_p, got_s = tq.pq_data_init(torch.from_numpy(zf), pt, st, cfg_t, **draws)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        assert set(got) == set(want)
        for k in want:
            _close_to_max(got[k], want[k], 1e-5)
    if vq_type == "ema":
        assert not torch.equal(got_s["ema_weight"], st["ema_weight"])
        assert float(got_s["ema_count"].abs().sum()) == 0.0
