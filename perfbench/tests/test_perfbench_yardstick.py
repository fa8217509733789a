"""The benchmark's own arithmetic: the FLOPs of ``tools/flops.py`` (the
backbone's from its module, ``reference/backbone_dino.py``), the train
step's terms and the rooflines of the two kernels."""
import pytest

from perfbench import yardstick
from perfbench.reference import backbone_dino


def widths(d):
    return dict(res=224, patch=8, embed_dim=d, depth=12, mlp_ratio=4, hidden=1024,
                num_pq=64, num_codebook=256, feature_samples=11)


@pytest.mark.parametrize("d,gflop", [(384, 46.69), (768, 160.10)])
def test_serving_flops_per_image(d, gflop):
    assert yardstick.segment_flops_per_image(widths(d)) / 1e9 == pytest.approx(gflop, abs=5e-3)


def test_attention_work_at_vit_s8_serving():
    w = yardstick.attention_work(128, 785, 384)        # packed qkv (128, 785, 1152)
    assert w["flops"] == 4 * 128 * 785 ** 2 * 384
    assert w["bytes"] == 2 * 128 * 785 * 1152 + 2 * 128 * 785 * 384
    assert yardstick.least_time(w["flops"], w["bytes"]) * 1e3 == pytest.approx(0.12250, abs=1e-5)


def test_pq_work_at_vit_s8_serving():
    w = yardstick.pq_work(100352, 1024, 64, 256)
    # bytes bound: z, z_norm and z_q in f32, both codebooks, int32 indices
    assert yardstick.least_time(w["flops"], w["bytes"]) * 1e3 == pytest.approx(0.37639, abs=1e-5)


def test_train_step_terms():
    t = yardstick.train_flops_terms(widths(768), 64, 20)
    assert t["backbone_fwd"] == 128 * backbone_dino.vit_flops(224, 8, 768, 12)
    assert t["pq_dist"] == 64 * yardstick.pq_flops(784, 1024, 256)
    # the backbone is most of it, the rest a few per cent
    total = yardstick.train_flops_per_step(widths(768), 64, 20)
    assert 0.9 < t["backbone_fwd"] / total < 0.97
    assert total / 1e12 == pytest.approx(21.362, abs=1e-3)
