"""``equss_tpu_torch/ops/kmeans.py`` against ``equss_tpu/ops/kmeans.py``.

* ``_assign`` gives JAX's indices wherever the two nearest centroids are
  more than 1e-4 apart in squared distance.
* k-means++ fed JAX's own draws (``randint(key, (M,), 0, n)`` for the
  first centroid, ``gumbel(k_i, (M, n))`` over ``split(fold_in(key, 1),
  k - 1)``) picks the same rows: its running minimum of the distances
  equals JAX's masked minimum over the chosen slots.
* ``kmeans`` after 10 Lloyd steps from JAX's seeds: centroids within 1e-5
  of their scale, assignments equal; the (n, d) and (M, n, d) forms.
* The random seeding from JAX's ``choice`` rows, with two equal rows
  among the seeds: the second's cluster is empty in the first step and
  keeps its centroid, as in JAX; after 10 steps, JAX's centroids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equss_tpu.ops import kmeans as jk
from equss_tpu_torch.ops import kmeans as tk
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)


def _t(x):
    return torch.from_numpy(np.array(x))


def _blobs(seed, M, n, d, centers=6):
    rs = np.random.RandomState(seed)
    c = rs.randn(M, centers, d) * 3.0
    which = rs.randint(0, centers, (M, n))
    return (np.take_along_axis(c, which[..., None], 1) + rs.randn(M, n, d)).astype(np.float32)


def jax_plus_plus_draws(key, M, n, k):
    """The draws of JAX's ``kmeans_plus_plus_init(key, x, k)``."""
    first = jax.random.randint(key, (M,), 0, n)
    keys = jax.random.split(jax.random.fold_in(key, 1), k - 1)
    noise = np.stack([np.asarray(jax.random.gumbel(ki, (M, n))) for ki in keys])
    return _t(first), _t(noise)


def test_assign_matches_jax_where_the_top_two_are_apart():
    x = _blobs(0, 3, 400, 8)
    c = _blobs(1, 3, 24, 8)
    want = np.asarray(jk._assign(jnp.asarray(x), jnp.asarray(c)))
    got = tk._assign(_t(x), _t(c)).numpy()
    d2 = ((x[:, :, None, :].astype(np.float64) - c[:, None].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d2, -1)[..., :2]
    apart = two[..., 1] - two[..., 0] > 1e-4
    assert apart.mean() > 0.99
    np.testing.assert_array_equal(got[apart], want[apart])


@pytest.mark.parametrize("M,n,d,k", [(1, 500, 16, 32), (3, 300, 6, 12)])
def test_plus_plus_with_jax_draws_picks_the_same_rows(M, n, d, k):
    x = _blobs(2, M, n, d)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jk.kmeans_plus_plus_init(key, jnp.asarray(x), k))
    first, noise = jax_plus_plus_draws(key, M, n, k)
    got = tk.kmeans_plus_plus_init(_t(x), k, first=first, gumbel_noise=noise).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(600, 12), (2, 400, 12)])
def test_lloyd_from_jax_seeds_matches_jax(shape):
    x = _blobs(3, 1 if len(shape) == 2 else shape[0], shape[-2], shape[-1])
    x = x.reshape(shape)
    M = 1 if len(shape) == 2 else shape[0]
    k = 16
    key = jax.random.PRNGKey(11)
    cents_j, assign_j = jk.kmeans(key, jnp.asarray(x), k=k, n_iters=10)
    first, noise = jax_plus_plus_draws(key, M, shape[-2], k)
    cents_t, assign_t = tk.kmeans(_t(x), k, n_iters=10, first=first, gumbel_noise=noise)
    cents_j = np.asarray(cents_j)
    assert cents_t.shape == cents_j.shape and assign_t.shape == assign_j.shape
    scale = np.abs(cents_j).max()
    np.testing.assert_allclose(cents_t.numpy(), cents_j, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(assign_t.numpy(), np.asarray(assign_j))


def test_random_seeds_from_jax_and_a_dead_cluster_keeps_its_centroid():
    M, n, d, k = 2, 300, 5, 10
    key = jax.random.PRNGKey(5)
    idx = np.asarray(jax.random.choice(key, n, (M, k), replace=False))
    x = _blobs(4, M, n, d)
    x[0, idx[0, 1]] = x[0, idx[0, 0]]          # two equal seeds: slot 1 starts dead
    for iters in (1, 10):
        cents_j, assign_j = jk.kmeans(key, jnp.asarray(x), k=k, n_iters=iters,
                                      plus_plus=False)
        cents_t, assign_t = tk.kmeans(_t(x), k, n_iters=iters, plus_plus=False,
                                      init_idx=_t(idx))
        cents_j = np.asarray(cents_j)
        if iters == 1:      # no row chose slot 1 in the first step: it kept its seed
            np.testing.assert_array_equal(cents_t[0, 1].numpy(), x[0, idx[0, 1]])
            np.testing.assert_array_equal(cents_j[0, 1], x[0, idx[0, 1]])
            assert not torch.equal(cents_t[0, 0], cents_t[0, 1])
        np.testing.assert_allclose(cents_t.numpy(), cents_j, rtol=0,
                                   atol=1e-5 * np.abs(cents_j).max())
        np.testing.assert_array_equal(assign_t.numpy(), np.asarray(assign_j))


def test_draws_from_a_generator():
    x = torch.from_numpy(_blobs(6, 2, 200, 4))
    a = tk.kmeans(x, 8, n_iters=3, generator=torch.Generator().manual_seed(1))
    b = tk.kmeans(x, 8, n_iters=3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and a[0].shape == (2, 8, 4) and a[1].shape == (2, 200)
    assert torch.isfinite(a[0]).all()
    # more seeding steps than one block of Gumbel draws: distinct rows
    x2 = torch.from_numpy(_blobs(7, 1, 400, 4)[0])
    c, _ = tk.kmeans(x2, 300, n_iters=0, generator=torch.Generator().manual_seed(2))
    assert c.shape == (300, 4) and len({tuple(r) for r in c.tolist()}) == 300
