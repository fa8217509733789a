"""A run's outside: no card means no result and a non-zero exit; the last
line's shape; nothing of JAX or of the JAX package loaded."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.tests.conftest import tiny

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
ARGS = ["--workload", "vit_s8.segment_b128", "--seed", str(2 ** 31 + 99), "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "perfbench.run", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_run_with_only_the_benchmark_files_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("wl", ["vit_s8.segment_b128", "vit_b8.train_b64"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_shape(wl, traced):
    c = tiny(wl)
    r = run.execute(c, 2 ** 31 + 11, 0.5, traced, CPU, time.time())
    json.dumps(r)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[:5] == keys
    assert ("breakdown" in r) == traced
    assert list(r)[-1] == "checks"             # the compared numbers come last
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(m in {x["name"] for x in c.per_layer} for m in r["metrics"])
    else:
        assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_driving_the_harness_loads_no_jax():
    code = ("import time, torch; from perfbench import run; "
            "from perfbench.tests.conftest import tiny; "
            "c = tiny('vit_b8.train_b64'); "
            "run.execute(c, 5, 0.2, True, torch.device('cpu'), time.time()); "
            "c = tiny('vit_s8.segment_b128'); "
            "run.execute(c, 5, 0.2, False, torch.device('cpu'), time.time()); "
            "print(run.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "equss_tpu_torch_lookalike", sys)
    assert "equss_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "equss_tpu.models", sys)
    assert run.forbidden_modules() == ["equss_tpu"]
