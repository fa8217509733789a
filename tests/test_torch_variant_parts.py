"""The parts of the first variants slice against the JAX package: the
loss library, the Sinkhorn cluster loss, the photometric view and the
residual blocks.

* Losses (``losses/basic.py``) on the same numpy inputs, JAX's random
  draws fed to the port: JSD, entropy, InfoNCE for every ``cal_type``
  and normaliser, JSD-positive and the proxy loss within rtol 1e-5;
  CLUB (the port's O(n d) form) and the blocked margin ranking within
  rtol 1e-4 of JAX and of their plain versions, the literal chunked CLUB
  and the unblocked margin (another summation order); the margin's
  gradient within 1e-4 of its scale of JAX's, at a block that does not
  divide n.
* ``distributed_sinkhorn`` and ``cluster_loss`` with no queue, with a
  partly filled queue (masked slots add nothing and their rows are
  zero) and with a full one: rtol 1e-5; a non-None ``axis_name`` raises.
* ``photometric_apply`` given JAX's own draws (``photometric_aug``'s
  seven keys) against JAX's ``photometric_aug``: within 1e-5 on >= 99.9%
  of the elements; where the hue lands on an HSV sector boundary a pixel
  may take the other sector's formula, bounded by 1e-2.  The port's
  ``photometric_draws`` lie in the ranges JAX draws from.
* The blocks: ``EncResBlock``, ``DecResBlock``, ``LinEncResBlock``,
  ``LinDecResBlock``, ``ResBlock`` (its 3x3 conv's flax kernel mapped by
  ``tree_from_flax``) and ``CLUBEncoder`` (with and without the residual)
  on flax weights: outputs within 1e-5; the BatchNorm blocks in training
  (batch statistics) and in eval (running averages), and the running
  statistics a training call returns against flax's mutated
  ``batch_stats``, within 1e-5; the VAE's ``ReLUResBlock`` and strided
  4x4 ``Conv2d``, and ``ConvTranspose2dTorch`` on the JAX kernel as
  ``convert`` flips it, within 1e-5.
* The blocked JSD (``jsd_loss``) at a block that does not divide the rows:
  value rtol 1e-5 of JAX's and of ``jsd_loss_reference``, gradients
  within 1e-5 of their scale of JAX's.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equss_tpu.data import transforms as jtf
from equss_tpu.losses import basic as jb
from equss_tpu.losses import sinkhorn as js
from equss_tpu.models import heads as jh
from equss_tpu_torch.convert import tree_from_flax
from equss_tpu_torch.data import transforms as ttf
from equss_tpu_torch.losses import basic as tb
from equss_tpu_torch.losses import sinkhorn as ts
from equss_tpu_torch.models import heads as th


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0)


def _maps(seed, shape=(2, 4, 5, 12), n=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------- losses

def test_jsd_and_entropy_match_jax():
    rng = np.random.RandomState(0)
    p = rng.dirichlet(np.ones(16), 40).astype(np.float32)
    q = rng.dirichlet(np.ones(16), 40).astype(np.float32)
    _close(tb.jsd_loss(_t(p), _t(q)), jb.jsd_loss(p, q), 1e-5)
    _close(tb.entropy_loss(_t(p)), jb.entropy_loss(p), 1e-5)


def test_blocked_jsd_matches_jax_and_the_unblocked_form():
    rng = np.random.RandomState(3)
    p = rng.dirichlet(np.ones(24), 50).astype(np.float32)
    q = rng.dirichlet(np.ones(24), 50).astype(np.float32)
    want, (gp, gq) = jax.value_and_grad(jb.jsd_loss, argnums=(0, 1))(jnp.asarray(p),
                                                                     jnp.asarray(q))
    pt, qt = _t(p).requires_grad_(), _t(q).requires_grad_()
    got = tb.jsd_loss(pt, qt, block=7)
    got.backward()
    _close(got.detach(), want, 1e-5)
    _close(tb.jsd_loss_reference(_t(p), _t(q)), want, 1e-5)
    for g, w in ((pt.grad, gp), (qt.grad, gq)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("cal_type,normalize", [
    ("random", "l2"), ("random", "z_norm"), ("random", "none"), ("distance", "l2"),
    ("cosine", "l2")])
def test_info_nce_matches_jax(cal_type, normalize):
    """The random negatives are JAX's own ``randint`` draw, given as
    ``idx``; distance and cosine mine theirs from the same matrices."""
    x1, x2 = _maps(1)
    key = jax.random.PRNGKey(3)
    kw = dict(normalize=normalize, temperature=0.5, neg_sample=7, cal_type=cal_type)
    want = jb.info_nce_loss(key, x1, x2, **kw)
    idx = None
    if cal_type == "random":
        idx = _t(jax.random.randint(key, (x1.size // 12, 7), 0, x1.size // 12))
    _close(tb.info_nce_loss(_t(x1), _t(x2), idx, **kw), want, 1e-5)


def test_info_nce_random_needs_its_draw():
    x1, x2 = _maps(1)
    with pytest.raises(ValueError, match="idx"):
        tb.info_nce_loss(_t(x1), _t(x2), cal_type="random")
    idx = tb.info_nce_draw(torch.Generator().manual_seed(0), 40, 7, "cpu")
    assert idx.shape == (40, 7) and 0 <= int(idx.min()) and int(idx.max()) < 40


@pytest.mark.parametrize("shape", [(2, 4, 5, 12), (1, 7, 9, 6)])
def test_club_loss_matches_jax_and_the_chunked_form(shape):
    """n = 40 (chunks of 1) and n = 63 (chunks of 2 rows: JAX averages the
    first 62 rows only, and so does the port)."""
    x, mu, lv = _maps(2, shape, 3)
    n, d = shape[0] * shape[1] * shape[2], shape[-1]
    mu, lv = mu.reshape(n, d), 0.3 * lv.reshape(n, d)
    want = jb.club_loss(x, mu, lv)
    got = tb.club_loss(_t(x), _t(mu), _t(lv))
    _close(got, want, 1e-4)
    _close(got, tb.club_loss_reference(_t(x), _t(mu), _t(lv)), 1e-4)
    _close(tb.club_loss_reference(_t(x), _t(mu), _t(lv)), want, 1e-5)


@pytest.mark.parametrize("block", [7, 40, 1024])
def test_margin_ranking_blocked_matches_jax_and_unblocked(block):
    ori, aug = _maps(3)
    aug[0, 0, 0] = aug[0, 0, 1]          # a tie: target 0 where t1 == t2
    want, grad_j = jax.value_and_grad(jb.margin_ranking_loss)(jnp.asarray(ori), aug)
    o = _t(ori).requires_grad_()
    got = tb.margin_ranking_loss(o, _t(aug), block=block)
    got.backward()
    _close(got.detach(), want, 1e-4)
    _close(got.detach(), tb.margin_ranking_loss_reference(_t(ori), _t(aug)), 1e-5)
    g = np.asarray(grad_j)
    np.testing.assert_allclose(o.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max())
    # the unblocked plain version differentiates to the same gradient
    o2 = _t(ori).requires_grad_()
    tb.margin_ranking_loss_reference(o2, _t(aug)).backward()
    np.testing.assert_allclose(o.grad.numpy(), o2.grad.numpy(), rtol=0,
                               atol=1e-5 * np.abs(g).max())


def test_jsd_pos_loss_matches_jax():
    z, zp = _maps(4)
    rng = np.random.RandomState(5)
    zd = rng.dirichlet(np.ones(6), (2, 4, 5)).astype(np.float32)
    zpd = rng.dirichlet(np.ones(6), (2, 4, 5)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jb.jsd_pos_loss(key, z, zp, zd, zpd, num_query=3, num_pos=4)
    rand_q = _t(jax.random.randint(key, (2, 3), 0, 20))
    got = tb.jsd_pos_loss(_t(z), _t(zp), _t(zd), _t(zpd), rand_q, num_pos=4)
    _close(got, want, 1e-5)


def test_proxy_loss_matches_jax():
    rng = np.random.RandomState(7)
    queue = rng.randn(4, 9, 8).astype(np.float32)
    centroids = rng.randn(4, 8).astype(np.float32)
    q_idx = rng.randint(0, 9, (4, 5)).astype(np.int32)
    neg_idx = rng.randint(0, 27, (4, 5 * 6)).astype(np.int32)
    want = jb.proxy_loss(jax.random.PRNGKey(0), queue, centroids, temperature=0.2,
                         num_queries=5, num_neg=6, sample_override=(q_idx, neg_idx))
    got = tb.proxy_loss(_t(queue), _t(centroids), _t(q_idx), _t(neg_idx), temperature=0.2)
    _close(got, want, 1e-5)


# --------------------------------------------------------------- sinkhorn

@pytest.mark.parametrize("live", [None, 0, 5, 16])
def test_sinkhorn_cluster_loss_matches_jax(live):
    """``live``: no queue, or a queue of 16 slots with that many live."""
    rng = np.random.RandomState(8)
    scores = rng.uniform(-1, 1, (30, 12)).astype(np.float32)
    kw = dict(temperature=0.1, epsilon=0.05)
    if live is None:
        want = js.cluster_loss(scores, **kw)
        got = ts.cluster_loss(_t(scores), **kw)
    else:
        queue = rng.uniform(-1, 1, (16, 12)).astype(np.float32)
        valid = np.arange(16) < live
        want = js.cluster_loss(scores, queue_scores=queue, queue_valid=valid, **kw)
        got = ts.cluster_loss(_t(scores), queue_scores=_t(queue), queue_valid=_t(valid), **kw)
        both = np.concatenate([queue, scores])
        mask = np.concatenate([valid, np.ones(30, bool)])
        q_t = ts.distributed_sinkhorn(_t(both), epsilon=0.05, valid=_t(mask))
        _close(q_t, js.distributed_sinkhorn(both, epsilon=0.05, valid=mask), 1e-5)
        assert torch.all(q_t[:16][~_t(valid)] == 0)
    _close(got, want, 1e-5)


def test_sinkhorn_axis_name_raises_naming_the_multi_gpu_item():
    with pytest.raises(NotImplementedError, match="item 7"):
        ts.distributed_sinkhorn(torch.zeros(3, 2), epsilon=0.05, axis_name="data")


# ---------------------------------------------------------- photometric

def _jax_draws(key, b, hue=0.1):
    """The seven draws of JAX's ``photometric_aug`` at its defaults, in the
    port's ``photometric_draws`` layout."""
    k = jax.random.split(key, 7)
    u = lambda kk, shape, lo, hi: jax.random.uniform(kk, shape, minval=lo, maxval=hi)  # noqa: E731
    return {"brightness": _t(u(k[0], (b, 1, 1, 1), 0.7, 1.3)),
            "contrast": _t(u(k[1], (b, 1, 1, 1), 0.7, 1.3)),
            "saturation": _t(u(k[2], (b, 1, 1, 1), 0.7, 1.3)),
            "hue": _t(u(k[3], (b, 1, 1), -hue, hue)),
            "to_gray": _t(jax.random.bernoulli(k[4], 0.2, (b, 1, 1, 1))),
            "sigma": _t(u(k[5], (b,), 3.0, 3.0)),
            "blur": _t(jax.random.bernoulli(k[6], 0.5, (b, 1, 1, 1)))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_photometric_apply_matches_jax_given_its_draws(seed):
    img = np.random.RandomState(seed).rand(8, 24, 20, 3).astype(np.float32)
    img[0, :4] = img[0, :4, :, :1]       # gray pixels: no hue (deltac = 0)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jtf.photometric_aug(key, jnp.asarray(img)))
    got = ttf.photometric_apply(_t(img), _jax_draws(key, 8)).numpy()
    diff = np.abs(got - want)
    assert (diff <= 1e-5).mean() >= 0.999 and diff.max() <= 1e-2, diff.max()


def test_photometric_draws_lie_in_jax_ranges():
    g = torch.Generator().manual_seed(0)
    d = ttf.photometric_draws(g, 4000, "cpu")
    for k in ("brightness", "contrast", "saturation"):
        assert 0.7 <= float(d[k].min()) and float(d[k].max()) <= 1.3, k
    assert -0.1 <= float(d["hue"].min()) and float(d["hue"].max()) <= 0.1
    assert torch.all(d["sigma"] == 3.0)
    assert 0.17 < d["to_gray"].float().mean() < 0.23 and 0.46 < d["blur"].float().mean() < 0.54
    img = torch.rand(2, 8, 8, 3, generator=g)
    out = ttf.photometric_aug(torch.Generator().manual_seed(1), img)
    assert out.shape == img.shape and 0.0 <= float(out.min()) and float(out.max()) <= 1.0


# ---------------------------------------------------------------- blocks

BLOCKS = {
    "EncResBlock": (lambda: jh.EncResBlock(12), lambda g: th.EncResBlock(8, 12, g)),
    "EncResBlock_same": (lambda: jh.EncResBlock(8), lambda g: th.EncResBlock(8, 8, g)),
    "LinEncResBlock": (lambda: jh.LinEncResBlock(12), lambda g: th.LinEncResBlock(8, 12, g)),
    "DecResBlock": (lambda: jh.DecResBlock(12), lambda g: th.DecResBlock(8, 12, g)),
    "DecResBlock_same": (lambda: jh.DecResBlock(8), lambda g: th.DecResBlock(8, 8, g)),
    "LinDecResBlock": (lambda: jh.LinDecResBlock(12), lambda g: th.LinDecResBlock(8, 12, g)),
    "ResBlock": (lambda: jh.ResBlock(12), lambda g: th.ResBlock(8, 12, g)),
    "ReLUResBlock": (lambda: jh.ReLUResBlock(12), lambda g: th.ReLUResBlock(8, 12, g)),
    "Conv4x4_stride2": (lambda: nn.Conv(6, (4, 4), strides=(2, 2), padding=[(1, 1), (1, 1)]),
                        lambda g: th.Conv2d(8, 6, g, k=4, stride=2, padding=1)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_blocks_match_flax(name):
    make_j, make_t = BLOCKS[name]
    x = np.random.RandomState(9).randn(3, 4, 5, 8).astype(np.float32)
    jm, tm = make_j(), make_t(torch.Generator().manual_seed(0))
    variables = jm.init(jax.random.PRNGKey(1), x)
    sd = tree_from_flax(variables["params"], "")
    bn = "batch_stats" in variables
    if bn:   # running statistics away from their init, so eval is tested
        stats = jax.tree.map(lambda v: v + 0.3 * np.random.RandomState(2).rand(*v.shape)
                             .astype(np.float32), variables["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": stats}
        sd.update(tree_from_flax(stats, ""))
    tm.load_state_dict(sd)
    if not bn:
        want = jm.apply(variables, x)
        np.testing.assert_allclose(tm(_t(x)).detach().numpy(), want, rtol=0, atol=1e-5)
        return
    want, mutated = jm.apply(variables, x, True, mutable=["batch_stats"])
    updates = {}
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    got = tm(_t(x), True, updates)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    for k, v in tm.state_dict().items():          # the forward wrote no buffer
        assert torch.equal(v, before[k]), k
    names = {mod: n for n, mod in tm.named_modules()}
    new = {f"{names[m]}.{s}": t for m, (mean, var) in updates.items()
           for s, t in (("mean", mean), ("var", var))}
    want_stats = tree_from_flax(mutated["batch_stats"], "")
    assert set(new) == set(want_stats)
    for k in new:
        np.testing.assert_allclose(new[k].numpy(), want_stats[k].numpy(), rtol=0, atol=1e-5)
    want_eval = jm.apply(variables, x, False)
    np.testing.assert_allclose(tm(_t(x), False).detach().numpy(), want_eval, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("hw", [(4, 5), (14, 14)])
def test_conv_transpose_matches_flax_through_converts_flip(hw):
    """``ConvTranspose2dTorch`` (torch's transposed 4x4, stride 2, padding
    1) on the JAX module's kernel as ``convert`` flips it in
    (``TRANSPOSED_CONVS``): within 1e-5, at twice the resolution; without
    the flip it differs."""

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, x):
            return jh.ConvTranspose2dTorch(6, name="upsample_t")(x)

    x = np.random.RandomState(12).randn(2, *hw, 8).astype(np.float32)
    jm = Wrap()
    variables = jm.init(jax.random.PRNGKey(3), x)
    want = np.asarray(jm.apply(variables, x))
    tm = th.ConvTranspose2dTorch(8, 6, torch.Generator().manual_seed(0))
    sd = tree_from_flax(variables["params"], "")
    tm.load_state_dict({k[len("upsample_t."):]: v for k, v in sd.items()})
    got = tm(_t(x)).detach().numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    unflipped = tree_from_flax({"other": variables["params"]["upsample_t"]}, "")
    tm.load_state_dict({k[len("other."):]: v for k, v in unflipped.items()})
    assert np.abs(tm(_t(x)).detach().numpy() - want).max() > 1e-3


@pytest.mark.parametrize("residual", [True, False])
def test_club_encoder_matches_flax(residual):
    x = np.random.RandomState(10).randn(2, 3, 4, 8).astype(np.float32)
    jm = jh.CLUBEncoder(hidden_dim=16, out_dim=8)
    params = jm.init(jax.random.PRNGKey(2), x)["params"]
    tm = th.CLUBEncoder(8, 16, 8, torch.Generator().manual_seed(0))
    tm.load_state_dict(tree_from_flax(params, ""))
    mu_j, lv_j = jm.apply({"params": params}, x, residual=residual)
    mu_t, lv_t = tm(_t(x), residual=residual)
    np.testing.assert_allclose(mu_t.detach().numpy(), mu_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lv_t.detach().numpy(), lv_j, rtol=0, atol=1e-5)


def test_as_state_keeps_weights_out_of_the_parameters():
    head = th.as_state(th.ExpansionHead(4, 6, torch.Generator().manual_seed(0)))
    assert list(head.parameters()) == []
    assert {k for k, _ in head.named_buffers()} == {
        f"{m}.{p}" for m in ("cluster1", "cluster2_fc1", "cluster2_fc2")
        for p in ("weight", "bias")}
    assert head(torch.zeros(1, 4)).shape == (1, 6)
