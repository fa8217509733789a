"""The control: the reference computed one step below the configuration's
stated precisions (bf16 -> fp8, f32 -> bf16), in the program's place,
has to read not correct.  On the CPU at vit_micro widths; on the card at
the cell's own size (marked ``gpu``), three seeds each."""
import importlib

import pytest
import torch

from perfbench import calibrate, cell as cells, check
from perfbench.reference import precision
from perfbench.tests.conftest import tiny

CPU = torch.device("cpu")


def test_control_lowers_each_stated_precision():
    cfg = cells.load("vit_s8.segment_b128").config
    assert precision.stated(cfg) == {"backbone": "bf16", "head": "f32", "pq": "bf16",
                                     "stego": "bf16", "probes": "f32"}
    assert precision.control(cfg) == {"backbone": "fp8", "head": "bf16", "pq": "fp8",
                                      "stego": "fp8", "probes": "bf16"}


def test_rounding_steps():
    x = torch.linspace(-3, 3, 1001)
    for prec, rel in (("bf16", 2 ** -8), ("fp8", 2 ** -3)):
        err = (precision.rnd(x, prec) - x).abs() / x.abs().clamp_min(1e-2)
        assert 0 < float(err.max()) <= rel * 1.01


def _readings(c, seed, device):
    drv = importlib.import_module(f"perfbench.drivers.{c.mix['driver']}")
    return calibrate.readings(c, drv, seed, 0.5, device, True)


@pytest.mark.parametrize("wl", ["vit_s8.segment_b128", "vit_b8.train_b64"])
def test_control_reads_well_above_the_program_on_the_cpu(wl):
    """At vit_micro widths the cell's limits, set at its own size, do not
    apply; the control reads at least three times the program's own
    reading on one of the numbers."""
    r = _readings(tiny(wl), 2 ** 31 + 33, CPU)
    ratio = max(r["control"][k] / max(r["program"][k], 1e-12) for k in r["control"]
                if k != "details")
    assert ratio >= 3.0, r


@pytest.mark.gpu
@pytest.mark.parametrize("wl", ["vit_s8.segment_b128", "vit_b8.train_b64",
                                "vit_b8.segment_b128"])
def test_control_reads_incorrect_at_the_cells_size(cuda, wl):
    c = cells.load(wl)
    for seed in (2 ** 31 + 41, 2 ** 31 + 42, 2 ** 31 + 43):
        r = _readings(c, seed, cuda)
        compared = {k: lim for k, lim in c.limits.items() if lim is not None}
        numbers = [(k, v, compared[k]) for k, v in r["control"].items() if k in compared]
        assert len(numbers) == len(compared)
        assert not check.verdict(numbers), (seed, numbers)
