"""The reduction of a traced slice: busy time as a union of intervals,
idle gaps labelled by the host span open over them, and the readers on a
made-up summary."""
import pytest
import torch

from perfbench import cell as cells, readers, trace, yardstick

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


def span_summary(units=2):
    """Two units of 100 µs each, their device events launched inside the
    program's spans (one launch never seen), every event apart from the
    others, so that device time, "unlinked" and idle tile the slice."""
    host = [("step.train_step", 0.0, 99.0), ("step.train_step", 100.0, 199.0)]
    prog, events, launch, blocking = [], [], [], []
    for u in range(units):
        o = 100.0 * u
        prog += [(n, o + a, o + b) for n, a, b in (
            ("equss.batch", 0, 10), ("equss.backbone", 10, 30), ("equss.head", 30, 40),
            ("equss.probes", 40, 50), ("equss.backward", 50, 70), ("equss.read", 70, 80),
            ("equss.optimizer", 80, 95))]
        for name, b, e, at in (("Memcpy HtoD (Pageable -> Device)", 5, 12, 2), ("gemm", 12, 30, 11),
                               ("ln", 30, 34, 31), ("argmax", 40, 48, 41),
                               ("gemm_bwd", 50, 75, 51), ("adam", 82, 90, 81),
                               ("lost", 90, 92, None)):
            events.append((name, o + b, o + e, trace.event_kind(name)))
            launch.append(None if at is None else o + at)
        blocking.append(("cudaStreamSynchronize", o + 75.0))
    blocking.append(("cudaDeviceSynchronize", 199.5))       # the slice's own, after the steps
    return {"units": units, "images": 128 * units, "slice_range_us": (0.0, 100.0 * units),
            "device_events": events, "launch_us": launch, "host_spans": host,
            "program_spans": prog, "blocking": blocking,
            "counters": {"h2d_bytes": 25_000_000 * units, "launch.attention_qkv": 24},
            "widths": W, "mix": {"batch": 128}, "classes": 27}


@pytest.mark.parametrize("metric,want", [
    ("backbone_ms_per_request.segment", 0.018), ("head_ms_per_request.segment", 0.004),
    ("probes_ms_per_request.segment", 0.008), ("backward_ms_per_step.train", 0.025),
    ("optimizer_ms_per_step.train", 0.008), ("host_syncs_per_step.train", 1.0),
    ("h2d_mb_per_step.train", 25.0)])
def test_the_span_readers_on_a_made_up_slice(metric, want):
    assert cells.reader(metric).read(span_summary()) == pytest.approx(want)


def test_span_ms_unlinked_and_idle_tile_the_slice():
    s = span_summary()
    by = readers.by_span(s)
    assert by["device_ms_by_span"]["unlinked"] == pytest.approx(0.002)
    assert by["device_ms_by_span"]["equss.batch"] == pytest.approx(0.007)
    work = sum(by["device_ms_by_span"].values())
    assert work == pytest.approx(1e3 * trace.busy_seconds(s) / s["units"])
    assert work + sum(by["idle_ms_by_span"].values()) == pytest.approx(by["window_ms"])
    assert by["window_ms"] == pytest.approx(0.1)


@pytest.mark.parametrize("metric", ["backbone_ms_per_request.segment",
                                    "backward_ms_per_step.train", "host_syncs_per_step.train",
                                    "h2d_mb_per_step.train"])
def test_the_span_readers_find_nothing_without_a_card(metric):
    s = {**span_summary(), "device_events": [], "launch_us": [], "counters": {}}
    assert cells.reader(metric).read(s) is None


def test_a_cpu_slice_keeps_the_programs_spans_apart():
    from equss_tpu_torch.core import trace as ptrace

    def body():
        with trace.span("step.one", True):
            with ptrace.span("equss.backbone"):
                torch.ones(4).sum()
            ptrace.count("h2d_bytes", 12)
        return {"units": 1}

    s = trace.profile_slice(body, torch.device("cpu"))
    assert [n for n, *_ in s["host_spans"]] == ["step.one"]
    assert [n for n, *_ in s["program_spans"]] == ["equss.backbone"]
    assert s["counters"] == {"h2d_bytes": 12}
    assert len(s["launch_us"]) == len(s["device_events"]) and s["blocking"] == []
