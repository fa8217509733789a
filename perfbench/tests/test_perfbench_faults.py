"""The timed path broken underneath a whole run (the look for a card
skipped, vit_micro on the CPU): each fault the cell can have makes
``correct`` false, also where only the window's steps carry it."""
import time

import pytest
import torch

from perfbench import faults, run
from perfbench.tests.conftest import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 21


def _run(wl, seconds=0.5, **mix):
    return run.execute(tiny(wl, **mix), SEED, seconds, False, CPU, time.time())


@pytest.mark.parametrize("fault", faults.SEGMENT)
def test_segment_faults_read_incorrect(fault):
    with faults.planted(fault):
        r = _run("vit_s8.segment_b128")
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_train_faults_read_incorrect(fault):
    with faults.planted(fault):
        r = _run("vit_b8.train_b64", batch=4)
    assert r["correct"] is False, (fault, r["checks"])


def test_train_state_unchanged_reads_one_on_the_median_leaf():
    with faults.planted("state_unchanged"):
        r = _run("vit_b8.train_b64")
    # every leaf at or above the median norm reads 1, the rest their norm
    # over the median's: the median leaf reads a half or more
    assert r["checks"]["change_gap_median"]["value"] >= 0.5


@pytest.mark.parametrize("fault", ["state_unchanged", "optimizer_left_out.cluster",
                                   "half_batch"])
def test_train_faults_of_the_window_alone_read_incorrect(fault):
    """The checked first steps and the warm-up run sound; the window's
    checked step catches what the window does differently."""
    c = tiny("vit_b8.train_b64", batch=4)
    sound = int(c.mix["checked_steps"]) + int(c.mix["warmup_steps"])
    with faults.planted(fault, after=sound):
        r = run.execute(c, SEED, 0.5, False, CPU, time.time())
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"] is False, (fault, checks)
    first = {k: v for k, v in r["checks"].items() if not k.startswith("window_")}
    assert all(v["value"] <= v["limit"] for v in first.values()), (fault, checks)
