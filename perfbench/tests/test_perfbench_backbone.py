"""A configuration's backbone, found by name (``cell.backbone``): the
seed's weights and the yardstick's counts of the DINO backbone as they
were before the backbone had a module of its own, pinned; a backbone that
is only a module under a new name serves the weights, the reference and
the counts of a run; a name with no file fails at load."""
import hashlib
import json
import shutil
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from perfbench import cell as cells, run, yardstick
from perfbench.reference import backbone_dino
from perfbench.tests.conftest import tiny
from perfbench.weights import make_weights

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 7

# sha256 over each tensor's name, shape and f32 bytes, in draw order, of the
# seed's weights on the CPU, and the yardstick's counts, read at the commit
# before the backbone module (0e1b25a)
PINNED = {
    "vit_s8.segment_b128": {
        "weights": "2c80b5e311335e0af8a132fcc4a781c7d87b061479d0ee995e96f0c4db3a3924",
        "segment_flops": 46686095360,
        "train_terms": {"backbone_fwd": 11471543599104, "head_fwd": 374870114304,
                        "head_bwd": 532710162432, "pq_dist": 52613349376,
                        "stego_fwd": 276296007680, "stego_bwd": 227808903168,
                        "probes": 38496632832}},
    "vit_b8.train_b64": {
        "weights": "a2dafa10299f15f320c8fdb21d584903ebeedda3170db80c05412fb1db1c4a3e",
        "segment_flops": 160097275904,
        "train_terms": {"backbone_fwd": 20005777833984, "head_fwd": 434060132352,
                        "head_bwd": 591900180480, "pq_dist": 26306674688,
                        "stego_fwd": 175824732160, "stego_bwd": 113904451584,
                        "probes": 14258012160}},
}


def digest(W):
    h = hashlib.sha256()
    for k, t in W.items():
        h.update(k.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("wl", sorted(PINNED))
def test_the_seeds_weights_equal_the_parents(wl):
    c = cells.load(wl)
    assert "backbone" not in c.widths        # the files name none: DINO's
    assert digest(make_weights(c.widths, c.classes, SEED, CPU)) == PINNED[wl]["weights"]


@pytest.mark.parametrize("wl", sorted(PINNED))
def test_the_yardsticks_counts_equal_the_parents(wl):
    c = cells.load(wl)
    assert yardstick.segment_flops_per_image(c.widths) == PINNED[wl]["segment_flops"]
    assert yardstick.train_flops_terms(c.widths, c.mix["batch"], c.classes) == \
        PINNED[wl]["train_terms"]


def stub(calls):
    """A backbone module under a new name: DINO's functions, each call
    recorded."""
    mod = types.ModuleType("perfbench.reference.backbone_stubtest")
    for name in ("weight_spec", "dense", "tokens", "flops"):
        def f(*a, _f=getattr(backbone_dino, name), _n=name):
            calls.append(_n)
            return _f(*a)
        setattr(mod, name, f)
    return mod


@pytest.mark.parametrize("wl", ["vit_s8.segment_b128", "vit_b8.train_b64"])
def test_a_backbone_added_as_a_module_serves_a_run(wl, monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "perfbench.reference.backbone_stubtest", stub(calls))
    c = tiny(wl)
    c.widths["backbone"] = "stubtest"
    traced = run.execute(c, SEED, 1.5, True, CPU, time.time())
    assert traced["correct"]
    # the weights drawn twice (the program's, the reference's), the reference
    # forward run, the attention roofline's tokens read
    assert calls.count("weight_spec") >= 2 and "dense" in calls and "tokens" in calls
    # the MFU reads the FLOPs where the window's untraced rest completed work,
    # which a loaded CPU may not reach in 1.5 s
    assert ("flops" in calls) == any(m.startswith("mfu_pct") for m in traced["metrics"])
    calls.clear()
    assert yardstick.segment_flops_per_image(c.widths) > 0
    assert yardstick.train_flops_terms(c.widths, 2, c.classes)["backbone_fwd"] == \
        4 * backbone_dino.flops(c.widths)
    assert calls == ["flops", "flops"]


def test_a_backbone_with_no_file_fails_at_load(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="perfbench/reference/backbone_nosuch.py"):
        cells.backbone({"backbone": "nosuch"})
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {x["name"]: x for x in bench["configs"]}["equss_vit_s8"]
    spec = json.loads((ROOT / conf["file"]).read_text())
    spec["widths"]["backbone"] = "nosuch"
    (tmp_path / conf["file"]).parent.mkdir(parents=True)
    (tmp_path / conf["file"]).write_text(json.dumps(spec))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    with pytest.raises(ValueError, match="no file perfbench/reference/backbone_nosuch.py"):
        cells.load("vit_s8.segment_b128")
