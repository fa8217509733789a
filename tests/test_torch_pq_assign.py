"""Port PQ assignment (equss_tpu_torch/ops/pq_assign.py) vs the JAX kernel.

``pq_assign_reference`` (what the wrapper runs on the CPU, and what the
CUDA kernel is held against on the card) against
``equss_tpu.ops.pq_pallas.pq_assign_pallas`` in Pallas interpret mode, for
every normalize mode in both precisions, with n not a multiple of the
JAX kernel's 512-row tile.  Same f32 inputs from a numpy seed.

Tolerances:
* exact mode: indices equal, z_q bit-equal (a gather of the raw f32
  codeword), z_norm within 1e-6 (f32 sums taken in another order);
* fast mode: >= 99.5% of indices equal (bf16 operands put many
  distances within an f32 rounding of each other, so the summation order
  decides some ties), and z_q equal to the bf16-rounded codeword at the
  port's own index.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from equss_tpu.ops.pq_pallas import pq_assign_pallas
from equss_tpu_torch.ops.pq_assign import pq_assign, pq_assign_reference

N, M, K, D = 700, 4, 128, 16
MODES = ("none", "l2", "z_norm", "z_trainable")


def _codebook_norm(cb: np.ndarray, mode: str) -> np.ndarray:
    """The normalised codebook pq_forward hands the kernel."""
    if mode == "none":
        return cb
    if mode == "l2":
        return cb / np.maximum(np.linalg.norm(cb, axis=-1, keepdims=True), 1e-12)
    axis = -1 if mode == "z_norm" else 1
    mean = cb.mean(axis, keepdims=True)
    std = np.sqrt(((cb - mean) ** 2).sum(axis, keepdims=True)
                  / (cb.shape[axis] - 1))
    return ((cb - mean) / (std + 1e-5)).astype(np.float32)


def _run_both(z, cn, cb, mode, exact, zm=None, zs=None):
    kw = dict(normalize=mode, exact=exact)
    jx = pq_assign_pallas(jnp.asarray(z), jnp.asarray(cn), jnp.asarray(cb),
                          z_mean=None if zm is None else jnp.asarray(zm),
                          z_std=None if zs is None else jnp.asarray(zs), **kw)
    t = lambda a: None if a is None else torch.from_numpy(a)   # noqa: E731
    pt = pq_assign_reference(t(z), t(cn), t(cb), z_mean=t(zm), z_std=t(zs), **kw)
    return [np.asarray(a) for a in jx], [a.numpy() for a in pt]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("mode", MODES)
def test_pq_assign_reference_matches_jax_kernel(mode, exact):
    rng = np.random.RandomState(MODES.index(mode))
    z = (3.0 * rng.randn(N, M, D)).astype(np.float32)
    cb = rng.randn(M, K, D).astype(np.float32)
    cn = _codebook_norm(cb, mode).astype(np.float32)
    zm = zs = None
    if mode == "z_trainable":
        zm = (0.1 * rng.randn(M, D)).astype(np.float32)
        zs = np.exp(0.1 * rng.randn(M, D)).astype(np.float32)
    (idx_j, zn_j, zq_j), (idx_t, zn_t, zq_t) = _run_both(z, cn, cb, mode, exact, zm, zs)

    assert idx_t.dtype == np.int32 and idx_t.shape == (N, M)
    np.testing.assert_allclose(zn_t, zn_j, rtol=1e-6, atol=1e-6)
    if exact:
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_array_equal(zq_t, zq_j)
        np.testing.assert_array_equal(zq_t, cb[np.arange(M), idx_t])
    else:
        assert np.mean(idx_t == idx_j) >= 0.995
        cb_bf16 = np.asarray(jnp.asarray(cb).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(zq_t, cb_bf16[np.arange(M), idx_t])


def test_pq_assign_tie_case_near_duplicate_codewords():
    """tests/test_pallas_kmeans.py's adversarial case: near-duplicate
    codewords and large z make f32 distances collapse into ties that the
    first index must win; the z^2 term and the add association decide
    which.  >= 99.5% as there (only last-ulp sum-order ties remain)."""
    rng = np.random.RandomState(42)
    n, m = 256, 8
    z = (1000.0 * rng.randn(n, m, D)).astype(np.float32)
    base = rng.randn(m, 1, D).astype(np.float32)
    cb = (base + 1e-5 * rng.randn(m, K, D)).astype(np.float32)
    (idx_j, _, _), (idx_t, _, _) = _run_both(z, cb, cb, "none", True)
    assert np.mean(idx_t == idx_j) >= 0.995


def test_pq_assign_wrapper_takes_plain_version_on_cpu():
    rng = np.random.RandomState(7)
    z = torch.from_numpy(rng.randn(50, 2, 8).astype(np.float32))
    cb = torch.from_numpy(rng.randn(2, 128, 8).astype(np.float32))
    before = pq_assign.launches
    got = pq_assign(z, cb, cb, normalize="l2", exact=False)
    assert pq_assign.launches == before              # no kernel launch
    for a, b in zip(got, pq_assign_reference(z, cb, cb, normalize="l2", exact=False)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        pq_assign(z, cb, cb, normalize="z_trainable")
    with pytest.raises(ValueError):
        pq_assign(z, cb[:, :, :4], cb, normalize="l2")
