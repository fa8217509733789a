"""The plain reference against the port at vit_micro widths on the CPU,
the port run in f32 (backbone, assignment and correlations), so that the
two compute the same numbers: predictions equal, the train step's loss,
first gradients and changes within f32 rounding.  The reference imports
nothing of the port."""
import ast
import dataclasses
import time
from pathlib import Path

import torch

from perfbench import run
from perfbench.tests.conftest import tiny

CPU = torch.device("cpu")


def f32(c):
    c.config["model"]["pretrained"]["precision"] = "f32"
    c.config["model"]["vq"]["assign_precision"] = "exact"
    c.config["loss"]["stego"]["correlation_precision"] = "exact"
    return c


def test_reference_predictions_equal_the_f32_port():
    wl = "vit_s8.segment_b128"
    r = run.execute(f32(tiny(wl)), 2 ** 31 + 3, 0.5, False, CPU, time.time())
    assert r["attempted"] >= 1
    assert r["checks"]["cluster_shortfall"]["value"] == 0.0
    assert r["checks"]["linear_shortfall"]["value"] == 0.0


def test_reference_train_steps_follow_the_f32_port():
    wl = "vit_b8.train_b64"
    c = f32(tiny(wl))
    # every number read, those the cell reads without comparing too
    c = dataclasses.replace(c, limits={k: 1.0 if v is None else v for k, v in c.limits.items()})
    r = run.execute(c, 2 ** 31 + 5, 0.5, False, CPU, time.time())
    checks = {k: v["value"] for k, v in r["checks"].items()}
    for prefix in ("", "window_"):      # the first steps, the window's step
        assert checks[prefix + "loss_gap"] < 1e-5, checks
        assert checks[prefix + "grad_gap_median"] < 1e-4, checks
        assert checks[prefix + "change_gap_median"] < 1e-4, checks
        assert checks[prefix + "change_gap_worst"] < 1e-3, checks
    assert checks["skipped_checked_steps"] == 0.0


def test_reference_imports_nothing_of_the_port():
    for path in (Path(__file__).resolve().parents[1] / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "typing", "perfbench",
                                           "__future__"}, (path.name, n)
