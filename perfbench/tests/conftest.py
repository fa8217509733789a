"""Fixtures of the benchmark's tests: the cells of ``BENCHMARK.json`` cut
to vit_micro widths and a batch of 2, for the CPU."""
import copy
import dataclasses

import pytest
import torch

from perfbench import cell as cells

MICRO = {"embed_dim": 32, "depth": 2, "num_heads": 2}


def tiny(workload: str, **mix) -> cells.Cell:
    """``workload`` at vit_micro widths, a batch of 2 and a small pool."""
    c = cells.load(workload)
    cfg = copy.deepcopy(c.config)
    cfg["model"]["pretrained"]["model_type"] = "vit_micro"
    small = {"batch": 2, "pool": 3, "check_requests": 2, "trace_requests": 2,
             "trace_steps": 2, **mix}
    return dataclasses.replace(c, config=cfg, widths={**c.widths, **MICRO},
                               mix={**c.mix, **{k: v for k, v in small.items()
                                                if k in c.mix or k in mix}})


@pytest.fixture(autouse=True)
def _one_thread():
    """Small elementwise ops on many threads are slow on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
