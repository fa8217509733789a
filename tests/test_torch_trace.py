"""The port's spans and counters (``equss_tpu_torch/core/trace.py``) at
``testing.tiny_pqgo_cfg`` sizes on the CPU.

* ``span`` is the shared null context unless the profiler records.
* One ``Predictor.forward`` and one ``Trainer.train_step`` under
  ``torch.profiler`` record each of their ``equss.*`` spans once, in the
  order of the layers, none inside another.
* ``export_predictor`` under an active profiler gives a graph without
  profiler ops.
* ``shard_batch`` counts a host batch's bytes in ``h2d_bytes`` once, and
  none for a batch that stays on the host.
* ``launch_counts`` keeps its keys; counters lose no increment made from
  several threads.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from equss_tpu_torch.core import trace
from equss_tpu_torch.ops import KERNEL_WRAPPERS, launch_counts, reset_launch_counts
from equss_tpu_torch.parallel import mesh
from equss_tpu_torch.testing import tiny_pqgo_cfg
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)

RES = 32
PREDICT_SPANS = ["equss.backbone", "equss.head", "equss.quantizer", "equss.probes"]
TRAIN_SPANS = ["equss.batch", "equss.backbone", "equss.head", "equss.quantizer",
               "equss.stego", "equss.probes", "equss.backward", "equss.read",
               "equss.optimizer"]


@pytest.fixture(scope="module")
def trainer():
    from equss_tpu_torch.train.trainer import Trainer

    return Trainer(tiny_pqgo_cfg(4), device="cpu", seed=0)


def _batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    shape = (b, RES, RES, 3)
    return {"img": rng.randint(0, 256, shape).astype(np.uint8),
            "img_pos": rng.randint(0, 256, shape).astype(np.uint8),
            "label": rng.randint(0, 4, shape[:3]).astype(np.int32)}


def _spans(fn):
    """The ``equss.*`` host ranges recorded while ``fn`` runs, in order of
    their start: ``(name, start_us, end_us)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("equss.")), key=lambda s: s[1])


def _disjoint(spans):
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_span_is_the_shared_null_context_outside_a_profiler():
    assert trace.span("equss.head") is trace.span("equss.backbone")
    with trace.span("equss.head"):
        pass
    from torch.profiler import profile

    with profile():
        assert trace.span("equss.head") is not trace.span("equss.backbone")
    assert trace.span("equss.head") is trace.span("equss.backbone")


def test_predictor_forward_records_each_span_once(trainer):
    from equss_tpu_torch.serve import build_predict_fn

    predict = build_predict_fn(trainer)
    img = torch.from_numpy(_batch()["img"])
    spans = _spans(lambda: predict(img))
    assert [s[0] for s in spans] == PREDICT_SPANS
    assert _disjoint(spans)


def test_train_step_records_each_span_once_in_layer_order(trainer):
    spans = _spans(lambda: trainer.train_step(_batch(1)))
    assert [s[0] for s in spans] == TRAIN_SPANS
    assert _disjoint(spans)


def test_export_under_the_profiler_carries_no_profiler_ops(trainer):
    from torch.profiler import profile

    from equss_tpu_torch.serve import export_predictor

    with profile():
        exported = export_predictor(trainer, (RES, RES), batch_size=2, symbolic_batch="off")
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def test_shard_batch_counts_a_host_batchs_bytes_once():
    batch = _batch(2)
    batch["path"] = np.array(["a.jpg", "b.jpg"])          # left out, not counted
    want = sum(batch[k].nbytes for k in ("img", "img_pos", "label"))
    before = trace.counts().get("h2d_bytes", 0)
    mesh.shard_batch(batch, "cpu")                        # stays on the host
    assert trace.counts().get("h2d_bytes", 0) == before
    out = mesh.shard_batch({**batch, "label": torch.from_numpy(batch["label"])}, "meta")
    assert set(out) == {"img", "img_pos", "label"} and out["img"].is_meta
    assert trace.counts()["h2d_bytes"] == before + want
    mesh.shard_batch(out, "meta")                         # already off the host
    assert trace.counts()["h2d_bytes"] == before + want


def test_launch_counts_keep_their_keys_and_read_the_registry():
    assert list(launch_counts()) == list(KERNEL_WRAPPERS) == [
        "attention_qkv", "attention", "layernorm", "add_layernorm", "pq_assign",
        "pq_assign_shard"]
    assert not [fn for fn in KERNEL_WRAPPERS.values() if hasattr(fn, "launches")]
    trace.count("launch.pq_assign", 3)
    trace.count("h2d_bytes", 5)
    assert launch_counts()["pq_assign"] >= 3
    h2d = trace.counts()["h2d_bytes"]
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}
    assert trace.counts()["h2d_bytes"] == h2d            # only the launch counters


def test_counters_lose_no_increment_across_threads():
    n_threads, n = 16, 2000
    before = trace.counts().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [trace.count("test.threads")
                                                    for _ in range(n)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not [t for t in threads if t.is_alive()]
    finally:
        sys.setswitchinterval(interval)
    assert trace.counts()["test.threads"] == before + n_threads * n
    trace.reset_counts("test.")
    assert "test.threads" not in trace.counts()
