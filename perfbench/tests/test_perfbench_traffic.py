"""The traffic and the weights repeat exactly for a seed and differ
across seeds."""
import numpy as np
import torch

from perfbench import traffic
from perfbench.tests.conftest import tiny
from perfbench.weights import make_weights

CPU = torch.device("cpu")
BIG = 2 ** 31 + 12345


def test_segment_pool_repeats_for_a_seed_and_differs_across_seeds():
    mix = tiny("vit_s8.segment_b128").mix
    a, b, c = (traffic.segment_pool(mix, s, CPU) for s in (BIG, BIG, BIG + 1))
    assert len(a) == mix["pool"] and a[0].dtype == torch.uint8
    assert a[0].shape == (mix["batch"], mix["res"], mix["res"], 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], a[1])           # the pool's batches are distinct


def test_train_pool_and_stego_draws_repeat_for_a_seed_and_differ_across_seeds():
    c = tiny("vit_b8.train_b64", batch=4)
    stego = c.config["loss"]["stego"]
    a, b, d = (traffic.train_pool(c.mix, s, c.classes, stego, CPU) for s in (BIG, BIG, 7))
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)
    for k in ("img", "img_pos", "label", "stego_coords1", "stego_coords2", "stego_perms"):
        assert not torch.equal(a[0][k], d[0][k]), k
    lab = a[0]["label"]
    assert lab.dtype == torch.int32 and int(lab.min()) >= -1 and int(lab.max()) < c.classes
    perms = a[0]["stego_perms"]
    assert perms.shape == (stego["neg_samples"], 4)
    for p in perms.numpy():
        # STEGO's super_perm: a permutation with its fixed points moved on by
        # one, so no image is its own negative
        assert p.min() >= 0 and p.max() < 4 and not np.any(p == np.arange(4))
    co = a[0]["stego_coords1"]
    assert co.shape == (4, stego["feature_samples"], stego["feature_samples"], 2)
    assert float(co.abs().max()) <= 1.0


def test_a_configuration_without_a_stego_loss_loads_and_draws_no_stego_samples():
    """A later cell's configuration may have no STEGO loss: the pool then
    carries no STEGO draws, and its correlations state no precision."""
    from perfbench.reference import precision

    c = tiny("vit_b8.train_b64", batch=4)
    pool = traffic.train_pool(c.mix, BIG, c.classes, None, CPU)
    assert set(pool[0]) == {"img", "img_pos", "label"}
    cfg = {**c.config, "loss": {k: v for k, v in c.config["loss"].items() if k != "stego"}}
    assert precision.stated(cfg)["stego"] == "f32"


def test_order_repeats_and_covers_the_pool():
    o = traffic.order(BIG, 8, 24)
    assert o == traffic.order(BIG, 8, 24) and o != traffic.order(BIG + 1, 8, 24)
    for r in range(3):
        assert sorted(o[8 * r:8 * r + 8]) == list(range(8))


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    c = tiny("vit_s8.segment_b128")
    a, b, d = (make_weights(c.widths, c.classes, s, CPU) for s in (BIG, BIG, BIG + 1))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.cluster1.weight"], d["head.cluster1.weight"])
    assert float(a["backbone.blocks.0.norm1.weight"].mean()) > 0.5   # scales near 1
    assert float(a["pq_state.vq_count"].abs().sum()) == 0.0
