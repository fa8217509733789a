"""Port pq_forward(training=False) (equss_tpu_torch/ops/quantizer.py) vs JAX.

The same codebook and features go through ``equss_tpu.ops.quantizer.
pq_forward`` and the port's, with ``use_pallas`` False (the XLA path and
its torch counterpart) and True (the Pallas kernel in interpret mode and
the port's kernel wrapper, which runs its plain version on the CPU).
JAX's CPU backend cannot run the bf16 one-hot einsum of the XLA path, so
the bf16 case with ``use_pallas=False`` is held against a numpy oracle of
that mode's definition instead.

Tolerances: exact mode indices equal, z_q within 1e-6 (the f32
straight-through sum zn + (zq - zn) of values that agree to an ulp),
losses within rtol 1e-5; bf16 mode >= 99% of indices equal (distances
rounded to bf16 tie often and the f32 sums before that rounding are taken
in another order).

The training options, each given JAX's draw (the keys split in
``pq_forward``'s order: dropout, then restart): the weighted-sum output
(z_q, loss and codebook gradient), ``pq_dropout`` (``keep``) and
``use_restart`` (``cand_idx``) for param and EMA codebooks, alone and
together: indices equal, z_q, losses and state within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from equss_tpu.ops import quantizer as jq
from equss_tpu_torch.ops import quantizer as tq
from equss_tpu_torch.ops.pq_assign import kernel_body, kernel_domain_error


def _cfgs(**kw):
    base = dict(num_pq=4, num_codebook=128, embed_dim=64, vq_type="param")
    base.update(kw)
    return jq.PQConfig(**base), tq.PQConfig(**base)


def _data(cfg_j, seed=0):
    params, state = jq.pq_init(jax.random.PRNGKey(seed), cfg_j)
    rng = np.random.RandomState(seed)
    z = rng.randn(2, 9, 7, cfg_j.embed_dim).astype(np.float32)
    if "z_mean" in params:
        params = dict(params,
                      z_mean=jnp.asarray(0.1 * rng.randn(*params["z_mean"].shape), jnp.float32),
                      z_log_var=jnp.asarray(0.1 * rng.randn(*params["z_log_var"].shape), jnp.float32))
    to_t = lambda tree: {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}  # noqa: E731
    return z, params, state, to_t(params), to_t(state)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernel"])
@pytest.mark.parametrize("normalize", ["l2", "z_norm", "z_trainable"])
def test_pq_forward_exact_matches_jax(normalize, use_pallas):
    cfg_j, cfg_t = _cfgs(normalize=normalize, use_pallas=use_pallas)
    z, pj, sj, pt, st = _data(cfg_j, seed=1)
    zq_j, idx_j, aux_j, _ = jq.pq_forward(jnp.asarray(z), pj, sj, cfg_j, training=False)
    zq_t, idx_t, aux_t, _ = tq.pq_forward(torch.from_numpy(z), pt, st, cfg_t)
    assert zq_t.shape == z.shape and idx_t.shape == (2, 9, 7, 4)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(zq_t.numpy(), np.asarray(zq_j), rtol=0, atol=1e-6)
    for key in ("vq-loss", "codebook-sum"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), rtol=1e-5)


def test_pq_forward_bf16_kernel_route_matches_jax():
    cfg_j, cfg_t = _cfgs(normalize="l2", use_pallas=True, assign_precision="bf16")
    z, pj, sj, pt, st = _data(cfg_j, seed=2)
    zq_j, idx_j, aux_j, _ = jq.pq_forward(jnp.asarray(z), pj, sj, cfg_j, training=False)
    zq_t, idx_t, aux_t, _ = tq.pq_forward(torch.from_numpy(z), pt, st, cfg_t)
    assert np.mean(idx_t.numpy() == np.asarray(idx_j)) >= 0.99
    same = idx_t.numpy() == np.asarray(idx_j)
    zq_t4 = zq_t.numpy().reshape(*same.shape, -1)
    zq_j4 = np.asarray(zq_j).reshape(*same.shape, -1)
    np.testing.assert_allclose(zq_t4[same], zq_j4[same], rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux_t["codebook-sum"]),
                               float(aux_j["codebook-sum"]), rtol=1e-5)
    np.testing.assert_allclose(float(aux_t["vq-loss"]), float(aux_j["vq-loss"]),
                               rtol=1e-2)


def test_pq_forward_bf16_xla_route_matches_oracle():
    """The bf16 XLA-path counterpart against numpy: dist = bf16(z_sq + c_sq
    - 2 cross) with bf16 operands, first-minimum argmin, z_q the bf16
    codeword (straight-through sum within 1e-6)."""
    cfg_j, cfg_t = _cfgs(normalize="l2", use_pallas=False, assign_precision="bf16")
    z, pj, sj, pt, st = _data(cfg_j, seed=3)
    zq_t, idx_t, _, _ = tq.pq_forward(torch.from_numpy(z), pt, st, cfg_t)

    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    M, d = cfg_j.num_pq, cfg_j.sub_dim
    cb = np.asarray(pj["codebook"])
    zf = z.reshape(-1, M, d)
    zn = zf / np.maximum(np.linalg.norm(zf, axis=-1, keepdims=True), 1e-12)
    cn = cb / np.maximum(np.linalg.norm(cb, axis=-1, keepdims=True), 1e-12)
    zb, cbn = bf(zn), bf(cn)
    dist = bf((bf(zb * zb).sum(-1)[:, :, None] + bf(cbn * cbn).sum(-1)[None])
              - 2.0 * np.einsum("nmd,mkd->nmk", zb, cbn))
    idx_o = dist.argmin(-1)
    idx = idx_t.numpy().reshape(-1, M)
    assert np.mean(idx == idx_o) >= 0.99
    expect = bf(cb)[np.arange(M), idx]
    np.testing.assert_allclose(zq_t.numpy().reshape(-1, M, d), expect, rtol=0, atol=1e-6)


def test_pq_forward_routing_and_inference_only():
    cfg = tq.PQConfig(num_pq=4, num_codebook=128, embed_dim=64)
    assert tq._kernel_eligible(cfg, 10, torch.device("cuda"))        # auto on CUDA
    assert not tq._kernel_eligible(cfg, 10, torch.device("cpu"))     # auto on CPU
    big = 1 + int(cfg.pallas_auto_bytes / (cfg.num_pq * cfg.num_codebook * 4))
    assert tq._kernel_eligible(cfg, big, torch.device("cpu"))
    # K = 2048 at d = 16 is inside the JAX predicate: the wide body takes it
    assert tq._kernel_eligible(dataclasses.replace(cfg, use_pallas=True, num_codebook=2048),
                               10, torch.device("cuda"))
    for bad in (dict(embed_dim=48, num_pq=4), dict(pq_dropout=0.1)):
        c = dataclasses.replace(cfg, use_pallas=True, **bad)
        assert not tq._kernel_eligible(c, 10, torch.device("cuda"))
    # training takes the kernel only under an explicit use_pallas
    # (train_route_ok), and EMA training never (it wants the distance
    # softmax); restart trains on the plain route, as in JAX
    assert not tq._kernel_eligible(cfg, 10, torch.device("cuda"), training=True)
    assert tq._kernel_eligible(dataclasses.replace(cfg, use_pallas=True), 10,
                               torch.device("cuda"), training=True)
    ema = dataclasses.replace(cfg, vq_type="ema", use_pallas=True)
    assert tq._kernel_eligible(ema, 10, torch.device("cuda"))
    assert not tq._kernel_eligible(ema, 10, torch.device("cuda"), training=True)
    restart = dataclasses.replace(ema, use_restart=True)
    params, state = tq.pq_init(torch.Generator().manual_seed(0), restart)
    _, _, _, new = tq.pq_forward(torch.ones(3, 64), params, state, restart, training=True,
                                 generator=torch.Generator().manual_seed(1))
    # three rows, 128 codewords: most are dead, restarted to rows of z
    assert float(new["ema_count"].abs().sum()) == 0.0
    assert (new["ema_weight"] == 1.0).all(-1).float().mean() > 0.9
    param_restart = dataclasses.replace(cfg, use_restart=True, use_pallas=True)
    assert not tq._kernel_eligible(param_restart, 10, torch.device("cuda"), training=True)
    assert tq._kernel_eligible(param_restart, 10, torch.device("cuda"))


def _header_domain(d: int, K: int, exact: bool) -> bool:
    """The (d, K) domain csrc/pq_assign.cu's header states: every d with
    d % 8 == 0 and every K >= 1, in both modes."""
    return d >= 8 and d % 8 == 0 and K >= 1


def _header_body(d: int, K: int, exact: bool) -> str:
    """The header's choice of body: narrow for d in {8, 16, 32} where one
    subspace's codebooks fit 232 448 bytes of shared memory, (8d + 4) K in
    exact mode, (4d + 4) roundup(K, 256 / d) beside 43 008 bytes of
    staging tiles in fast mode; else wide."""
    if d not in (8, 16, 32):
        return "wide"
    chunk = 256 // d
    need = (8 * d + 4) * K if exact else (4 * d + 4) * (-(-K // chunk) * chunk) + 43008
    return "narrow" if need <= 232448 else "wide"


@pytest.mark.parametrize("precision", ["exact", "bf16"])
@pytest.mark.parametrize("d", [4, 8, 12, 16, 32, 64])
def test_kernel_eligibility_on_cuda_is_the_kernel_domain(d, precision):
    """On CUDA the predicate is true exactly inside the kernel's domain,
    so it never picks a shape the wrapper refuses, and the body that runs
    is the header's; on the CPU it keeps the JAX package's TPU layout rule
    (d % 8, K % 128)."""
    exact = precision == "exact"
    for K in (1, 100, 128, 256, 257, 512, 894, 895, 1432, 1433, 1761, 1762, 2784, 2785, 4096):
        cfg = tq.PQConfig(num_pq=4, num_codebook=K, embed_dim=4 * d, use_pallas=True,
                          assign_precision=precision)
        inside = _header_domain(d, K, exact)
        assert (kernel_domain_error(d, K, exact) is None) == inside
        if inside:
            assert kernel_body(d, K, exact) == _header_body(d, K, exact)
        assert tq._kernel_eligible(cfg, 10, torch.device("cuda")) == inside
        assert tq._kernel_eligible(cfg, 10, torch.device("cpu")) == (
            d % 8 == 0 and K % 128 == 0)


# ------------------------------------------------ training options vs JAX

def _option_case(vq_type, seed, **kw):
    """M = 2, K = 24, d = 8 on 60 rows: z (3, 5, 4, 16) and a codebook on
    the data's scale (an EMA state of some standing), so that some
    codewords win no row of the batch."""
    base = dict(num_pq=2, num_codebook=24, embed_dim=16, vq_type=vq_type, **kw)
    cfg_j, cfg_t = jq.PQConfig(**base), tq.PQConfig(**base)
    rng = np.random.RandomState(seed)
    params, state = jq.pq_init(jax.random.PRNGKey(seed), cfg_j)
    params = {k: np.array(v) for k, v in params.items()}
    state = {k: np.array(v) for k, v in state.items()}
    cb = rng.randn(2, 24, 8).astype(np.float32)
    if vq_type == "param":
        params["codebook"] = cb
    else:
        state.update(ema_weight=cb, ema_weight_avg=cb * 1.5,
                     ema_count=(np.abs(rng.randn(2, 24)) * 3).astype(np.float32))
    z = rng.randn(3, 5, 4, 16).astype(np.float32)
    return cfg_j, cfg_t, params, state, z


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _jax_draws(key, cfg, n, dropout, restart):
    """The draws JAX's ``pq_forward`` makes from ``key``: the dropout
    mask, then the restart's candidate rows."""
    out, rng = {}, key
    if dropout:
        rng, k = jax.random.split(rng)
        out["keep"] = torch.from_numpy(np.array(
            jax.random.uniform(k, (cfg.num_pq, cfg.num_codebook)) > cfg.pq_dropout))
    if restart:
        rng, k = jax.random.split(rng)
        out["cand_idx"] = torch.from_numpy(np.array(
            jax.random.randint(k, (cfg.num_pq, cfg.num_codebook), 0, n)))
    return out


@pytest.mark.parametrize("vq_type", ["param", "ema"])
@pytest.mark.parametrize("dropout,restart", [(0.3, False), (0.0, True), (0.3, True)],
                         ids=["dropout", "restart", "dropout+restart"])
def test_dropout_and_restart_match_jax_given_its_draws(vq_type, dropout, restart):
    cfg_j, cfg_t, params, state, z = _option_case(
        vq_type, 7, normalize="l2", pq_dropout=dropout, use_restart=restart)
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(key, cfg_j, 60, dropout > 0, restart)
    zq_j, idx_j, aux_j, st_j = jq.pq_forward(
        jnp.asarray(z), {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()}, cfg_j, training=True, rng=key)
    zq_t, idx_t, aux_t, st_t = tq.pq_forward(torch.from_numpy(z), _torch(params),
                                             _torch(state), cfg_t, training=True, **draws)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(zq_t, zq_j)
    for k in ("vq-loss", "codebook-usage", "codebook-sum"):
        _close(aux_t[k], aux_j[k])
    assert set(st_t) == set(st_j)
    for k in st_j:
        _close(st_t[k], st_j[k])
    if dropout:
        # a dropped codeword wins no row; entry 0 always stays
        keep = draws["keep"].clone()
        keep[:, 0] = True
        won = torch.zeros(2, 24, dtype=torch.bool)
        won[torch.arange(2).expand(60, 2), idx_t.reshape(60, 2).long()] = True
        assert not (won & ~keep).any() and (~keep).any()
    if restart and vq_type == "param":
        _close(aux_t["restarted-codebook"], aux_j["restarted-codebook"])
        dead = np.asarray(st_j["vq_count"]) == np.asarray(state["vq_count"])
        assert dead.any()
        assert not np.array_equal(aux_t["restarted-codebook"].numpy(), params["codebook"])
    if restart and vq_type == "ema":
        assert float(st_t["ema_count"].abs().sum()) == 0.0      # reset: a code was dead
    # the port's own draw: a generator in place of the given ones
    tq.pq_forward(torch.from_numpy(z), _torch(params), _torch(state), cfg_t, training=True,
                  generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="requires a generator"):
        tq.pq_forward(torch.from_numpy(z), _torch(params), _torch(state), cfg_t,
                      training=True)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_weighted_sum_matches_jax(training):
    """``use_weighted_sum`` (param, ``normalize: none``): z_q the softmax
    mean of the codebook with no straight-through step, the loss and the
    codebook's gradient of ``sum(z_q) + vq-loss`` within 1e-5."""
    cfg_j, cfg_t, params, state, z = _option_case("param", 8, normalize="none",
                                                  use_weighted_sum=True, jsd_ts=0.5)
    sj = {k: jnp.asarray(v) for k, v in state.items()}

    def f_j(cb):
        zq, idx, aux, _ = jq.pq_forward(jnp.asarray(z), {"codebook": cb}, sj, cfg_j,
                                        training=training)
        return jnp.sum(zq) + aux["vq-loss"], (zq, idx, aux)

    (_, (zq_j, idx_j, aux_j)), g_j = jax.value_and_grad(f_j, has_aux=True)(
        jnp.asarray(params["codebook"]))
    cb = torch.from_numpy(params["codebook"]).requires_grad_()
    zq_t, idx_t, aux_t, _ = tq.pq_forward(torch.from_numpy(z), {"codebook": cb},
                                          _torch(state), cfg_t, training=training)
    (zq_t.sum() + aux_t["vq-loss"]).backward()
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(zq_t, zq_j)
    _close(aux_t["vq-loss"], aux_j["vq-loss"])
    _close(aux_t["distance_prob"], aux_j["distance_prob"])
    _close(cb.grad, g_j)
    # not the nearest codeword: a mean of several
    nearest = params["codebook"][np.arange(2), idx_t.reshape(-1, 2).numpy()]
    assert np.abs(zq_t.detach().numpy().reshape(-1, 2, 8) - nearest).max() > 1e-3
    assert not tq._kernel_eligible(dataclasses.replace(cfg_t, use_pallas=True), 10,
                                   torch.device("cuda"), training=training)


# ------------------------------------------------ the codeword gather

@pytest.mark.parametrize("M,K,d,n,shard", [
    (64, 256, 16, 37, None),           # the pqgo quantizer
    (1, 2048, 384, 29, None),          # unseg's wide codebook
    (64, 128, 16, 37, (1, 2)),         # a K shard's local indices (rank 1 of 2)
], ids=["pqgo", "wide", "shard"])
def test_gather_codewords_is_the_advanced_index(M, K, d, n, shard):
    """The flat row gather gives the advanced index's rows bit for bit, on
    a whole codebook and on a K shard indexed by its local indices."""
    g = torch.Generator().manual_seed(M + K + d)
    codebook = torch.randn((M, K, d), generator=g)
    idx = torch.randint(0, K, (n, M), generator=g, dtype=torch.int32)
    if shard is not None:
        rank, ranks = shard
        whole = torch.randn((M, K * ranks, d), generator=g)
        codebook = whole[:, rank * K:(rank + 1) * K]          # a strided slice
    got = tq._gather_codewords(codebook, idx)
    assert got.shape == (n, M, d)
    assert torch.equal(got, codebook[torch.arange(M), idx.long()])
    assert torch.equal(tq._gather_codewords(codebook, idx, tq._flat_rows(idx, M, K)), got)


def _gather_case(seed):
    """M = 4, K = 32, d = 16 on 126 rows, a codebook on the data's scale:
    each used codeword takes several rows of a subspace."""
    base = dict(num_pq=4, num_codebook=32, embed_dim=64, vq_type="param", normalize="l2")
    rng = np.random.RandomState(seed)
    cb = rng.randn(4, 32, 16).astype(np.float32)
    z = rng.randn(2, 9, 7, 64).astype(np.float32)
    w = rng.randn(2, 9, 7, 64).astype(np.float32)            # z_q cotangent
    return base, cb, z, w


def _advanced_index_gather(codebook, indices, flat=None):
    """The gather as the advanced index: autograd transposes it by
    ``index_put_(accumulate=True)``."""
    return codebook[torch.arange(codebook.shape[0]), indices.long()]


def _port_codebook_grad(cfg, cb, z, w):
    cbt = torch.from_numpy(cb).requires_grad_()
    state = {"vq_count": torch.zeros(cfg.num_pq, cfg.num_codebook)}
    zq, idx, aux, _ = tq.pq_forward(torch.from_numpy(z), {"codebook": cbt}, state, cfg,
                                    training=True)
    (aux["vq-loss"] + (zq * torch.from_numpy(w)).sum()).backward()
    return idx, cbt.grad


@pytest.mark.parametrize("precision", ["exact", "bf16"])
def test_plain_route_codebook_gradient(precision, monkeypatch):
    """The codebook's gradient through a training ``pq_forward`` on the
    plain route (``use_pallas: auto`` on the CPU) against (a) the
    advanced index's transpose: within 1e-5 of the gradient's scale, as
    the two sum each codeword's rows in another f32 order; and (b) the
    JAX package's one-hot VJP at the port's indices (the bf16 codeword
    rounded on both sides; the z_q cotangent's straight-through term
    gives the codebook nothing): within the file's 1e-5."""
    base, cb, z, w = _gather_case(4)
    cfg_t = tq.PQConfig(**base, assign_precision=precision)
    cfg_j = jq.PQConfig(**base, assign_precision=precision)
    assert not tq._kernel_eligible(cfg_t, 126, torch.device("cpu"), training=True)
    idx, grad = _port_codebook_grad(cfg_t, cb, z, w)
    counts = np.bincount(idx.reshape(-1, 4).numpy()[:, 0], minlength=32)
    assert counts.max() >= 5                                 # duplicates to sum
    with monkeypatch.context() as m:
        m.setattr(tq, "_gather_codewords", _advanced_index_gather)
        idx_a, grad_a = _port_codebook_grad(cfg_t, cb, z, w)
    assert torch.equal(idx, idx_a)
    _close(grad, grad_a.numpy())

    M, d = cfg_j.num_pq, cfg_j.sub_dim
    fixed = jnp.asarray(idx.reshape(-1, M).numpy())

    def loss(cb_j):
        zn = jq.normalize_vectors(jnp.asarray(z).reshape(-1, M, d), cfg_j.normalize)
        src = cb_j.astype(jnp.bfloat16).astype(jnp.float32) if precision == "bf16" else cb_j
        zq = jq._gather_codewords(src, fixed)
        return cfg_j.book * jnp.mean((zq - jax.lax.stop_gradient(zn)) ** 2)

    _close(grad, jax.grad(loss)(jnp.asarray(cb)))


def _backward_ops(cfg, codebook_grad):
    """The aten ops of one backward through a training ``pq_forward``."""
    base, cb, z, w = _gather_case(5)
    zt = torch.from_numpy(z).requires_grad_()
    params, state = tq.pq_init(torch.Generator().manual_seed(0), cfg)
    if cfg.vq_type == "param":
        params = {"codebook": torch.from_numpy(cb).requires_grad_(codebook_grad)}
    zq, _, aux, _ = tq.pq_forward(zt, params, state, cfg, training=True)
    loss = aux["vq-loss"] + (zq * torch.from_numpy(w)).sum()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loss.backward()
    assert zt.grad is not None
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("vq_type", ["param", "ema"])
def test_plain_route_gather_transposes_by_index_add(vq_type):
    """The param codebook's gradient is one ``index_add_`` scatter, with no
    ``index_put_``; an EMA codebook takes no gradient, so its backward
    runs neither."""
    base = dict(_gather_case(5)[0], vq_type=vq_type)
    ops = _backward_ops(tq.PQConfig(**base), codebook_grad=True)
    assert "aten::_index_put_impl_" not in ops and "aten::index_put_" not in ops
    assert ("aten::index_add_" in ops) == (vq_type == "param")
