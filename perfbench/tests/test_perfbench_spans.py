"""The benchmark's traced slice over a program that has spans of its own
(``equss_tpu_torch/core/trace.py``'s ``equss.*`` ranges): the slice's
summary holds the benchmark's spans alone, so the per-layer readers read
what they read without the program's spans.  On a card (marked ``gpu``):
requests with the program's spans on and off launch the same device
events, and none of the spans' device-side mirrors is one of them.
``spans.py`` puts device work, idle gaps and blocking calls down to the
program's spans."""
import time
from collections import Counter

import pytest
import torch

from perfbench import spans, trace, traffic
from perfbench.tests.conftest import tiny

TRAIN_SPANS = {f"equss.{n}" for n in ("batch", "backbone", "head", "quantizer", "stego",
                                      "probes", "backward", "read", "optimizer")}


def test_attribute_puts_each_event_down_to_the_span_of_its_launch():
    """A step: the batch copy, a forward kernel, and a backward kernel that
    autograd's thread launched while the step's thread waited inside
    ``equss.backward``; the metrics read blocks, and the card idles."""
    ranges = [("step.train_step", 0, 100), ("equss.batch", 0, 10),
              ("equss.backbone", 10, 30), ("equss.backward", 30, 60),
              ("equss.read", 60, 70), ("equss.optimizer", 70, 95)]
    device = [("Memcpy HtoD", 5, 15, 2.0), ("gemm", 15, 40, 12.0),
              ("gemm_bwd", 40, 70, 31.0), ("adam", 80, 90, 72.0), ("lost", 90, 92, None)]
    out = spans.attribute(ranges, device, [("cudaStreamSynchronize", 65.0)], (0, 100), 2)
    assert out["device_ms_by_span"] == pytest.approx(
        {"equss.batch": 0.005, "equss.backbone": 0.0125, "equss.backward": 0.015,
         "equss.optimizer": 0.005, "unlinked": 0.001})
    # idle 0-5 (batch), 70-80 (optimizer), 92-100 (the step between spans)
    assert out["idle_ms_by_span"] == pytest.approx(
        {"equss.optimizer": 0.005, "step.train_step": 0.004, "equss.batch": 0.0025})
    assert out["top_gaps_ms"][0] == ["equss.optimizer", pytest.approx(0.01)]
    assert out["blocking_calls_by_span"] == {"equss.read": 0.5}
    assert out["window_ms"] == pytest.approx(0.05)


def test_spans_runs_a_train_cell_on_the_cpu():
    out = spans.run(tiny("vit_b8.train_b64"), 3, torch.device("cpu"), pairs=1)
    assert out["units"] == 2 and out["device_events"] == 0
    assert out["blocking_calls_by_span"] == {} and out["device_ms_by_span"] == {}
    # no device: one gap over the slice, at whichever span is open at its middle
    assert set(out["idle_ms_by_span"]) <= TRAIN_SPANS | {"step.train_step", "host"}
    for mode in ("on", "off"):
        assert len(out["spans_on_off"][mode]["slice_ms"]["all"]) == 2


def test_a_train_step_under_the_slice_keeps_the_programs_spans_out(monkeypatch):
    from equss_tpu_torch.core import trace as ptrace
    from equss_tpu_torch.train.trainer import Trainer

    c = tiny("vit_b8.train_b64")
    pool = traffic.train_pool(c.mix, 5, c.classes, c.config["loss"].get("stego"),
                              torch.device("cpu"))
    trainer = Trainer(c.config, device="cpu", seed=0)
    span, opened = ptrace.span, []

    def recorded(name):
        ctx = span(name)
        if ctx is not ptrace._NULL:
            opened.append(name)
        return ctx

    monkeypatch.setattr(ptrace, "span", recorded)

    def body():
        for b in pool[:2]:
            with trace.span("step.train_step", True):
                trainer.train_step(b)
        return {"units": 2}

    s = trace.profile_slice(body, torch.device("cpu"))
    assert Counter(opened)["equss.backward"] == Counter(opened)["equss.optimizer"] == 2
    assert {n for n, *_ in s["host_spans"]} == {"step.train_step"}
    assert s["device_events"] == []


@pytest.mark.gpu
def test_on_the_card_the_spans_move_no_device_event(cuda, monkeypatch):
    """One slice serves a request to warm up, three requests with the
    program's spans on and three with them off, the card drained between
    the groups: the two groups' device events are the same kernels.  The
    host waits between the groups, so that the device's clock, which the
    profiler maps onto the host's with some error, puts no event into
    the wrong group."""
    from equss_tpu_torch.core import trace as ptrace
    from equss_tpu_torch.serve import build_predict_fn
    from equss_tpu_torch.train.trainer import Trainer

    from perfbench import cell as cells

    c = cells.load("vit_s8.segment_b128")
    trainer = Trainer(c.config, device=cuda, seed=0)
    predict = build_predict_fn(trainer)
    img = torch.randint(0, 256, (8, 224, 224, 3), dtype=torch.uint8, device=cuda)
    predict(img)
    span = ptrace.span

    def group(name, on):
        monkeypatch.setattr(ptrace, "span", span if on else (lambda _: ptrace._NULL))
        with trace.span(name, True):
            for _ in range(1 if name == "request.warm" else 3):
                predict(img)
            torch.cuda.synchronize(cuda)
            time.sleep(0.05)

    def body():
        group("request.warm", True)
        group("request.on", True)
        group("request.off", False)
        return {"units": 3}

    s = trace.profile_slice(body, cuda)
    starts = {n: b for n, b, _ in s["host_spans"]}
    on = Counter(e[0] for e in s["device_events"] if starts["request.on"] < e[1]
                 < starts["request.off"])
    off = Counter(e[0] for e in s["device_events"] if e[1] > starts["request.off"])
    assert sum(on.values()) > 3 * 100 and on == off
    assert not [n for n, *_ in s["device_events"] if n.startswith("equss.")]
