"""``BENCHMARK.json`` against the files the harness finds by its names."""
import json
import re
from pathlib import Path

import pytest

from equss_tpu_torch.models.vit import make_vit_config
from perfbench import cell as cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(wl):
    c = cells.load(wl)
    assert c.limits
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer
    moved = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in moved, m["name"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(metric):
    """``BENCHMARK.json`` alone holds a metric's unit, layer and ``moves``;
    its reader is found by its name."""
    mod = cells.reader(metric["name"])
    assert callable(mod.read)
    assert not {"UNIT", "LAYER", "MOVES"} & set(vars(mod))


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_every_limit_states_its_readings(wl):
    c = cells.load(wl)
    spec = json.loads((ROOT / "perfbench" / "limits" / f"{wl}.json").read_text())
    for name, v in spec["numbers"].items():
        assert v["from"], name
        if c.limits[name] is not None:
            assert v["lower"] < c.limits[name] < v["upper"], name


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    spec = json.loads((ROOT / conf["file"]).read_text())
    assert spec["name"] == conf["name"] and spec["reduced"] == conf["reduced"]
    pre = spec["config"]["model"]["pretrained"]
    vit = make_vit_config(pre["model_type"], pre["dino_patch_size"])
    w = spec["widths"]
    assert (w["embed_dim"], w["depth"], w["num_heads"], w["patch"]) == (
        vit.embed_dim, vit.depth, vit.num_heads, vit.patch_size)
    vq = spec["config"]["model"]["vq"]
    assert spec["widths"]["num_pq"] == vq["num_pq"][0]
    assert spec["widths"]["num_codebook"] == vq["num_codebooks"][0]
    assert spec["widths"]["hidden"] == vq["embed_dims"][0]
