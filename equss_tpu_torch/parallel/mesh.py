"""Multi-process data parallelism: one global program over the ranks of a
``torch.distributed`` process group.

The port's counterpart of ``equss_tpu/parallel/mesh.py``.  The JAX
trainer runs as one global program over a data mesh: each process feeds
its local rows, ``shard_batch`` assembles the global array, and every
contraction over the batch axis sees the global batch.  The port keeps
that program with explicit collectives.  Each rank holds its own rows of
every batch (``data/pipeline.py`` and ``data/synthetic.py`` slice by
rank) and the same parameters, and the trainer's steps run inside
``global_program()``, under which the modules reduce or gather what
couples rows:

* ``all_reduce_sum``: sums over the ranks (the quantizer's counts and
  sums, the Sinkhorn's, the confusion matrices, the flattened gradient,
  the CLUB encoder's inner gradients);
* ``mean_over_ranks``: the mean of equal-sized per-rank means
  (differentiable: BatchNorm's statistics, STEGO's feature-correlation
  means, the CLUB term's moments of x, the entropy's mean assignment);
* ``gather_rows``: the global batch on every rank, differentiable (the
  STEGO negatives, which may be another rank's image; the InfoNCE
  negatives and the margin ranking's columns, whose gradient flows back
  to the rank that owns the row; the rows of the SwAV queue, the EMA
  bank, an EMA codebook's JSD and NewVQ's stage-1 k-means);
  ``parts`` reorders rank blocks of a stacked ``[img; aug_img]`` into the
  one-process order;
* ``global_rows`` / ``local_rows``: a random draw made at the global
  batch size from the generator every rank holds in the same state, of
  which each rank keeps its own rows (dropout masks, STEGO's coordinates,
  the photometric view's factors, the InfoNCE negatives, the quantizers'
  Gumbel noise).

A loss term on a rank is its share of the global term: the mean over
the ranks of their values is the one-process value on the global batch
(the trainer backpropagates each rank's share over the world size and
sums the gradients).  A per-row mean over a rank's equal share of rows
is its share as it stands; a term that every rank computes alike on
gathered rows (the EMA bank's proxy loss, an EMA codebook's JSD) is its
own share.  The data-dependent inits (``Trainer.data_init``: the k-means
and ``rand`` codebooks, EMAModel's bank) run on every rank, outside the
program, on the gathered images as one process would, with the same
draws; their results and NewVQ's stage-1 selection are then taken from
rank 0 (``broadcast_``), so that a nondeterministic scatter on a card
cannot set the ranks apart.

Outside ``global_program()`` (serving, exports) or without a group every
helper is the identity and no collective runs.  A group of one rank runs
the collectives, which then change no bit: what a one-rank run costs
over a run without a group.  Only ``all_reduce`` and
``broadcast`` are used, the two collectives the gloo backend carries for
CUDA tensors as well as CPU ones; a gather is an all-reduce of
zero-padded rows.

Bring-up: ``init_distributed`` (NCCL for a CUDA trainer, gloo for the
CPU or when asked), after which ``world()`` and ``rank()`` read the
group.  ``replicate`` broadcasts a module's weights from rank 0,
``broadcast_object`` any picklable object, ``barrier`` waits for every
rank.  ``make_mesh`` lists the local devices that sharded serving
(``serve.build_sharded_predict_fn``) splits a request over.  The JAX
package's tensor-parallel layouts (``make_mesh_2d``, ``shard_quantizer``,
``shard_backbone``) are not ported: ROADMAP.md queue 1, item 9.
"""
from __future__ import annotations

import contextlib
import os
import pickle
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from equss_tpu_torch.device import DeviceLike, resolve_device

TENSOR_PARALLEL_ITEM = "ROADMAP.md queue 1, item 9 (tensor parallelism)"


# ------------------------------------------------------------- the group
def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: DeviceLike = None, backend: Optional[str] = None,
                     auto: bool = False) -> None:
    """Join the process group of a multi-process run; a no-op for one
    process.  ``coordinator`` (``HOST:PORT``) is rank 0's TCP store,
    ``num_processes`` the world size, ``process_id`` this rank.
    ``auto`` reads all three from a launcher's environment instead
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), as ``torchrun`` sets them.  ``backend`` defaults to NCCL
    when ``device`` (default CUDA) is a CUDA device, else gloo; a CUDA
    rank then takes ``local_device(device)`` as its current device."""
    if dist.is_initialized():
        return
    if not auto and (num_processes is None or int(num_processes) <= 1):
        return
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if auto:
        dist.init_process_group(backend, init_method="env://")
    else:
        if not coordinator or process_id is None:
            raise ValueError("a multi-process run needs dist.coordinator (HOST:PORT) and "
                             "dist.process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes), rank=int(process_id))
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(dev))


def in_group() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if in_group() else 0


def local_rank() -> int:
    """This process's index among the processes of its host: the
    launcher's ``LOCAL_RANK`` where set, else the rank modulo the host's
    CUDA devices (one process per card, ranks numbered host by host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return rank() % n if n else 0


def local_device(device: DeviceLike = None) -> torch.device:
    """The device this rank runs on: a CUDA device without an index
    becomes ``cuda:{local_rank()}``; any other device stays as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current
    CUDA device under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Wait until every rank arrives (no-op for one process)."""
    if world() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def broadcast_object(obj: Any, is_source: bool = True) -> Any:
    """``obj`` of rank 0 on every rank (no-op for one process): its
    pickle's length first, then the payload at that length, so no
    fixed-size buffer truncates it."""
    if world() == 1:
        return obj
    dev = _comm_device()
    payload = pickle.dumps(obj) if is_source else b""
    size = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    dist.broadcast(size, src=0)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=dev)
    if is_source:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    return pickle.loads(buf.cpu().numpy().tobytes())


def replicate(module: nn.Module) -> nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's, in place
    (no-op for one process): the state ``replicate`` gives every device
    in the JAX package.  Ranks that built the module from one seed hold
    these values already; the broadcast also covers weights read on one
    rank only."""
    if world() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                _broadcast_(t)
    return module


def _broadcast_(t: torch.Tensor) -> None:
    """Rank 0's ``t`` into ``t``, through the group's device."""
    dev = _comm_device()
    if t.device == dev:
        dist.broadcast(t, src=0)
    else:
        tmp = t.to(dev)
        dist.broadcast(tmp, src=0)
        t.copy_(tmp)


# --------------------------------------------------------------- batches
def shard_batch(batch: Dict[str, Any], device: DeviceLike) -> Dict[str, torch.Tensor]:
    """A host batch's numeric arrays on ``device``.  Each rank passes its
    own rows of the global batch, as the data pipeline yields them.
    Entries that are not numeric arrays (the image paths a corpus
    carries) stay host-side: they are left out, as in the JAX package."""
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            out[k] = v.to(device, non_blocking=True)
        elif hasattr(v, "dtype") and np.dtype(v.dtype).kind not in ("U", "S", "O"):
            out[k] = torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
    return out


def device_prefetch(batches: Iterable[Dict[str, Any]], device: DeviceLike,
                    depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """``shard_batch`` of each batch, ``depth`` batches ahead on a
    transfer thread."""
    from equss_tpu_torch.core.prefetch import threaded_prefetch

    yield from threaded_prefetch(batches, depth=depth,
                                 map_fn=lambda b: shard_batch(b, device))


def make_mesh(n_devices: Optional[int] = None, device_type: Optional[str] = None
              ) -> List[torch.device]:
    """The local devices a sharded predictor splits a batch over: the
    first ``n_devices`` CUDA cards (all of them when None; raises without
    CUDA), or with ``device_type="cpu"`` ``n_devices`` replicas on the
    host (default 1)."""
    if device_type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    resolve_device(device_type or "cuda")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"requested a {n}-device mesh but only {count} CUDA device(s) "
                         f"are visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh_2d(data: int, model: int):
    raise NotImplementedError(f"the (data, model) mesh is not ported: {TENSOR_PARALLEL_ITEM}")


def shard_quantizer(*args, **kwargs):
    raise NotImplementedError(f"shard_quantizer is not ported: {TENSOR_PARALLEL_ITEM}")


def shard_backbone(*args, **kwargs):
    raise NotImplementedError(f"shard_backbone is not ported: {TENSOR_PARALLEL_ITEM}")


# ------------------------------------------------------ the global program
class _Program:
    """The ranks a ``global_program()`` runs over."""

    def __init__(self, size: int, index: int):
        self.world, self.rank = size, index


_PROGRAM: Optional[_Program] = None


@contextlib.contextmanager
def global_program():
    """Run the enclosed code as the ranks' share of one global program:
    inside, the helpers below reduce and gather over the group's ranks.
    Every rank must enter it and issue the same collectives in the same
    order, which the same program on the same shapes does.  Without a
    group it changes nothing."""
    global _PROGRAM
    prev = _PROGRAM
    _PROGRAM = _Program(world(), rank()) if in_group() else None
    try:
        yield
    finally:
        _PROGRAM = prev


def in_program() -> bool:
    """Whether a global program over a group is running."""
    return _PROGRAM is not None


def program_world() -> int:
    """The ranks of the running global program (1 outside one)."""
    return _PROGRAM.world if _PROGRAM is not None else 1


def program_rank() -> int:
    return _PROGRAM.rank if _PROGRAM is not None else 0


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place, through the group's device."""
    dev = _comm_device()
    if t.device == dev:
        dist.all_reduce(t)
    else:
        tmp = t.to(dev)
        dist.all_reduce(tmp)
        t.copy_(tmp)
    return t


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the program's ranks, in place (outside autograd);
    ``t`` itself outside a program."""
    if in_program():
        _all_reduce_(t)
    return t


class _MeanOverRanks(torch.autograd.Function):
    """The mean over the ranks; its gradient, the mean of the ranks'
    gradients, is the same reduce."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce_(t.detach().clone()) / program_world()

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone()) / program_world()


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the program's ranks, differentiable: the
    global mean where ``t`` is a mean over equal-sized per-rank rows.
    ``t`` itself outside a program."""
    return _MeanOverRanks.apply(t) if in_program() else t


def broadcast_(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` into ``t`` on every rank of the program, in place
    (outside autograd); ``t`` itself outside a program."""
    if in_program():
        _broadcast_(t)
    return t


class _GatherRows(torch.autograd.Function):
    """The ranks' equal-sized row blocks concatenated in rank order; the
    gradient of a rank's block is the sum over the ranks of the gradient
    they took at it."""

    @staticmethod
    def forward(ctx, t):
        n, w, r = t.shape[0], program_world(), program_rank()
        full = t.new_zeros((n * w, *t.shape[1:]))
        full[r * n:(r + 1) * n] = t.detach()
        return _all_reduce_(full)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // program_world()
        r = program_rank()
        return _all_reduce_(g.contiguous().clone())[r * n:(r + 1) * n]


def _blocks_to_parts(full: torch.Tensor, parts: int) -> torch.Tensor:
    """Rank-ordered blocks of ``parts`` stacked parts each -> the parts'
    global rows stacked: [a_0; b_0; a_1; b_1] -> [a_0; a_1; b_0; b_1]."""
    if parts == 1:
        return full
    w = program_world()
    per = full.shape[0] // (w * parts)
    return full.reshape(w, parts, per, *full.shape[1:]).transpose(0, 1).reshape(full.shape)


def gather_rows(t: torch.Tensor, parts: int = 1) -> torch.Tensor:
    """The global batch (every rank's rows of ``t``, in rank order) on
    every rank, differentiable; ``t`` itself outside a program.  Every
    rank must hold the same number of rows.  ``parts`` > 1 says the local
    rows are that many blocks of the batch stacked (``[img; aug_img]``):
    the result is then each part's global rows, stacked in that order, as
    one process stacks them."""
    if not in_program():
        return t
    return _blocks_to_parts(_GatherRows.apply(t), parts)


def local_rows(full: torch.Tensor, parts: int = 1) -> torch.Tensor:
    """This rank's rows of a tensor of the global batch's rows (``full``
    itself outside a program).  ``parts`` as in ``global_rows``."""
    if not in_program():
        return full
    w = program_world()
    n = full.shape[0] // w
    per = n // parts
    return full.reshape(parts, w, per, *full.shape[1:])[:, program_rank()].reshape(
        n, *full.shape[1:])


def global_rows(draw: Callable[[int], torch.Tensor], n: int, parts: int = 1) -> torch.Tensor:
    """``draw(rows)`` made at the global batch size, and this rank's rows
    of it: the draw a one-process run makes, split as the batch is.
    ``parts`` > 1 says the local rows are that many blocks of the batch
    stacked (``[img; img_pos]``), each split over the ranks on its own.
    Every rank draws from a generator in the same state, so all stay in
    step."""
    if not in_program():
        return draw(n)
    return local_rows(draw(n * program_world()), parts)
