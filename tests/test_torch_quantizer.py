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
    # softmax); branches of a later slice raise
    assert not tq._kernel_eligible(cfg, 10, torch.device("cuda"), training=True)
    assert tq._kernel_eligible(dataclasses.replace(cfg, use_pallas=True), 10,
                               torch.device("cuda"), training=True)
    ema = dataclasses.replace(cfg, vq_type="ema", use_pallas=True)
    assert tq._kernel_eligible(ema, 10, torch.device("cuda"))
    assert not tq._kernel_eligible(ema, 10, torch.device("cuda"), training=True)
    restart = dataclasses.replace(ema, use_restart=True)
    params, state = tq.pq_init(torch.Generator().manual_seed(0), restart)
    with pytest.raises(NotImplementedError, match="use_restart"):
        tq.pq_forward(torch.zeros(3, 64), params, state, restart, training=True)


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
