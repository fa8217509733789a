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
from equss_tpu_torch.ops import launch_counts
from equss_tpu_torch.ops.pq_assign import key_argmin, kernel_body, pq_assign, pq_assign_reference

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


# (K, d) beyond the base case: K = 256 puts index 255 in all 8 packed
# bits, K = 512 takes the fast mode's (value, index) minimum, d = 8 and
# d = 32 the kernel's other widths
SHAPES = ((K, D), (256, D), (512, D), (K, 8), (K, 32))
CASES = [pytest.param(mode, exact, k, d, id=f"{mode}-{'exact' if exact else 'fast'}"
                      + ("" if (k, d) == (K, D) else f"-K{k}-d{d}"))
         for k, d in SHAPES for mode in MODES for exact in (True, False)]


@pytest.mark.parametrize("mode,exact,K,D", CASES)
def test_pq_assign_reference_matches_jax_kernel(mode, exact, K, D):
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
    assert idx_t.min() >= 0 and idx_t.max() < K
    np.testing.assert_allclose(zn_t, zn_j, rtol=1e-6, atol=1e-6)
    if exact:
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_array_equal(zq_t, zq_j)
        np.testing.assert_array_equal(zq_t, cb[np.arange(M), idx_t])
    else:
        assert np.mean(idx_t == idx_j) >= 0.995
        cb_bf16 = np.asarray(jnp.asarray(cb).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(zq_t, cb_bf16[np.arange(M), idx_t])


# the wide shapes of the configs outside the pqgo family, which the CUDA
# kernel's wide body takes: (M, K, d) of new_vq/spq, contra, vq
WIDE = ((2, 2048, 64), (1, 1024, 128), (1, 256, 1024))
WIDE_CASES = [pytest.param(mode, exact, m, k, d, id=f"{mode}-{'exact' if exact else 'fast'}"
                           f"-M{m}-K{k}-d{d}")
              for m, k, d in WIDE for mode in ("none", "l2") for exact in (True, False)]


@pytest.mark.parametrize("mode,exact,M,K,D", WIDE_CASES)
def test_pq_assign_reference_matches_jax_kernel_wide(mode, exact, M, K, D):
    """The plain version at the wide body's shapes against the JAX kernel
    (one subspace per block-diagonal dot there, G = 1), with the bars of
    the narrow shapes."""
    rng = np.random.RandomState(K + D)
    z = rng.randn(300, M, D).astype(np.float32)
    cb = rng.randn(M, K, D).astype(np.float32)
    cn = _codebook_norm(cb, mode).astype(np.float32)
    (idx_j, zn_j, zq_j), (idx_t, zn_t, zq_t) = _run_both(z, cn, cb, mode, exact)
    np.testing.assert_allclose(zn_t, zn_j, rtol=1e-6, atol=1e-6)
    if exact:
        np.testing.assert_array_equal(idx_t, idx_j)
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
    before = launch_counts()["pq_assign"]
    got = pq_assign(z, cb, cb, normalize="l2", exact=False)
    assert launch_counts()["pq_assign"] == before              # no kernel launch
    for a, b in zip(got, pq_assign_reference(z, cb, cb, normalize="l2", exact=False)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        pq_assign(z, cb, cb, normalize="z_trainable")
    with pytest.raises(ValueError):
        pq_assign(z, cb[:, :, :4], cb, normalize="l2")


@pytest.mark.parametrize("d,K", [(8, 3418), (16, 1760), (32, 894)])
def test_kernel_body_narrow_exact_boundary(d, K):
    """The last K the narrow exact body takes at each width, by the rule
    (8d + 4) K <= 232 448 bytes of shared memory; one codeword more goes
    to the wide body."""
    assert (8 * d + 4) * K <= 232448 < (8 * d + 4) * (K + 1)
    assert kernel_body(d, K, True) == "narrow"
    assert kernel_body(d, K + 1, True) == "wide"


def _strict_scan(row):
    """The exact bodies' minimum: a strict-< scan in codeword order from
    (+inf, 0), so NaN is never taken and equal distances keep the first."""
    best, best_d = 0, float("inf")
    for k, v in enumerate(row):
        if v < best_d:
            best, best_d = k, v
    return best


NAN, INF = float("nan"), float("inf")
KEY_ROWS = [
    pytest.param([3.0, 1.0, 1.0, 2.0], id="tie"),
    pytest.param([0.0, -0.0, 1.0, 2.0], id="pos-neg-zero"),
    pytest.param([-0.0, 0.0, 1.0, 2.0], id="neg-pos-zero"),
    pytest.param([1.0, -0.0, 0.0, -0.0], id="zeros-after"),
    pytest.param([-1e-7, -3e-7, -3e-7, 0.0], id="negative"),
    pytest.param([INF, 5.0, INF, 5.0], id="inf"),
    pytest.param([INF, INF, INF, INF], id="all-inf"),
    pytest.param([NAN, 2.0, NAN, 2.0], id="nan"),
    pytest.param([-NAN, 2.0, 1.0, -NAN], id="negative-nan"),
    pytest.param([NAN, INF, NAN, INF], id="nan-inf"),
    pytest.param([NAN, NAN, NAN, NAN], id="all-nan"),
    pytest.param([-INF, -1e30, -INF, 0.0], id="minus-inf"),
]


@pytest.mark.parametrize("row", KEY_ROWS)
def test_key_argmin_matches_first_minimum(row):
    """The exact wide body's key combine (``key_argmin``, the plain version
    of its ``atomicMin``) on hand-made distances: equal to the strict-<
    scan everywhere, and to ``argmin``'s first minimum where no NaN is."""
    d = torch.tensor(row, dtype=torch.float32)
    # -NAN as a Python float keeps the sign bit: make sure the tensor does
    d = torch.where(torch.isnan(d) & torch.tensor([np.signbit(v) for v in row]),
                    -torch.tensor(NAN), d)
    got = key_argmin(d[None])[0].item()
    assert got == _strict_scan(row)
    if not any(v != v for v in row) and min(row) < INF:
        assert got == d.argmin().item()


def test_key_argmin_matches_argmin_on_exact_distances():
    """Random distances with many ties (rounded to a coarse grid, signs
    mixed), and the exact-mode distances of ``pq_assign_reference``: the
    key combine equals ``argmin``'s first minimum on every row."""
    rng = np.random.RandomState(12)
    d = torch.from_numpy((np.round(rng.randn(4000, 37) * 4) / 8).astype(np.float32))
    assert torch.equal(key_argmin(d), d.argmin(-1).to(torch.int32))
    z = torch.from_numpy(3 * rng.randn(300, 2, 24).astype(np.float32))
    cb = torch.from_numpy(rng.randn(2, 100, 24).astype(np.float32))
    cb[:, 50:] = cb[:, :50]                       # duplicated codewords: exact ties
    idx, zn, _ = pq_assign_reference(z, cb, cb, normalize="l2", exact=True)
    dist = ((zn * zn).sum(-1, keepdim=True) + (cb * cb).sum(-1)) \
        - 2.0 * torch.einsum("nmd,mkd->nmk", zn, cb)
    assert torch.equal(key_argmin(dist), idx)
    assert bool((idx < 50).all())
