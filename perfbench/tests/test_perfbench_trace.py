"""The reduction of a traced slice: busy time as a union of intervals,
idle gaps labelled by the host span open over them, and the readers on a
made-up summary."""
import pytest
import torch

from perfbench import cell as cells, trace, yardstick

W = dict(res=224, patch=8, embed_dim=384, depth=12, mlp_ratio=4, hidden=1024, num_pq=64,
         num_codebook=256, feature_samples=11)


def summary(events, units=1, spans=()):
    return {"units": units, "images": 128 * units, "slice_range_us": (0.0, 1000.0),
            "device_events": events, "host_spans": list(spans), "widths": W,
            "mix": {"batch": 128}, "classes": 27,
            "rest": {"units": 10, "images": 1280, "seconds": 0.5}}


def test_busy_is_a_union_and_gaps_carry_the_open_span():
    s = summary([("k1", 100.0, 300.0, "kernel"), ("k2", 200.0, 400.0, "kernel"),
                 ("Memcpy HtoD", 600.0, 700.0, "memcpy")],
                spans=[("request.predict", 0.0, 500.0), ("request.copy_out", 450.0, 800.0)])
    assert trace.busy_seconds(s) == pytest.approx(400e-6)
    gaps = trace.idle_gaps(s)
    assert gaps[0] == ("host", pytest.approx(300e-6))              # 700..1000: no span
    assert ("request.copy_out", pytest.approx(200e-6)) in gaps     # 400..600: inner span
    assert ("request.predict", pytest.approx(100e-6)) in gaps      # 0..100
    assert cells.reader("device_idle_pct.segment").read(s) == pytest.approx(60.0)
    assert cells.reader("launches_per_request.segment").read(s) == 2
    assert cells.reader("copy_ms_per_request.segment").read(s) == pytest.approx(0.1)


def test_rooflines_count_the_cells_work_over_matching_kernels():
    att = yardstick.attention_work(128, 785, 384)
    t = yardstick.least_time(att["flops"], att["bytes"]) * 1e6       # us
    s = summary([("void attention_kernel<64>(...)", 0.0, 2 * t, "kernel")] * 12)
    assert cells.reader("attention_roofline_pct.segment").read(s) == pytest.approx(50.0)
    assert cells.reader("pq_roofline_pct.segment").read(s) is None    # no PQ kernel ran


def test_mfu_reads_the_untraced_rate():
    s = summary([])
    want = 100 * 2560 * yardstick.segment_flops_per_image(W) / yardstick.PEAK_BF16_FLOPS
    assert cells.reader("mfu_pct.segment").read(s) == pytest.approx(want)
    s["rest"]["seconds"] = 0.0
    assert cells.reader("mfu_pct.segment").read(s) is None


def test_a_cpu_slice_keeps_the_benchmarks_spans_off_the_device():
    s = trace.profile_slice(lambda: (torch.ones(4).sum(), {"units": 1})[1], torch.device("cpu"))
    assert s["units"] == 1 and s["slice_range_us"] is not None
    assert all(not n.startswith(trace.SPAN_PREFIXES) for n, *_ in s["device_events"])
