"""One cell of ``BENCHMARK.json`` and every file the harness finds by its
names: the configuration (``configs/<config>.json``), its backbone
(``reference/backbone_<name>.py``, where ``name`` is the configuration's
``widths["backbone"]``, ``dino`` where it names none), the traffic mix
(``traffic/<traffic>.json``), the limits of its comparison
(``limits/<workload>.json``) and the per-layer readers
(``metrics/<metric>.py``) of the metrics it reports."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]          # the program's configuration dict
    widths: Dict[str, Any]          # the model's sizes, as the reference reads them
    mix: Dict[str, Any]
    limits: Dict[str, Optional[float]]     # None: read and recorded, not compared
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def classes(self) -> int:
        return int(self.config["num_classes"])


def _reports(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def backbone(w: Dict[str, Any]) -> ModuleType:
    """The backbone module of widths ``w``: its weights, its plain
    reference, its tokens and FLOPs (``reference/backbone_dino.py``)."""
    name = w.get("backbone", "dino")
    module = f"perfbench.reference.backbone_{name}"
    path = Path(PACKAGE.name, "reference", f"backbone_{name}.py")
    if module not in sys.modules and not (PACKAGE.parent / path).is_file():
        raise ValueError(f"backbone {name!r}: no file {path}")
    return importlib.import_module(module)


def load(workload: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    c = cells[workload]
    conf = {x["name"]: x for x in bench["configs"]}[c["config"]]
    spec = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((PACKAGE / "traffic" / f"{c['traffic']}.json").read_text())
    limits = json.loads((PACKAGE / "limits" / f"{workload}.json").read_text())
    widths = dict(spec["widths"])
    backbone(widths)
    stego = spec["config"].get("loss", {}).get("stego")
    if stego is not None:
        widths["feature_samples"] = stego["feature_samples"]
    if mix["res"] != widths["res"]:
        raise ValueError(f"{workload}: traffic at {mix['res']}^2, the model's grid is "
                         f"for {widths['res']}^2")
    return Cell(name=workload, chips=int(c["chips"]), config=spec["config"], widths=widths,
                mix=mix,
                limits={k: None if v["limit"] is None else float(v["limit"])
                        for k, v in limits["numbers"].items()},
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``, loaded by its file (metric names hold dots)."""
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
