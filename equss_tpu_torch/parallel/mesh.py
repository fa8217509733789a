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
(``serve.build_sharded_predict_fn``) splits a request over.

Tensor parallelism: ``make_mesh_2d(data, model)`` lays the ranks out as a
(data, model) grid (rank r at (r // model, r % model), JAX's
``devices.reshape(data, model)``) and builds its data groups (the ranks
of one model index) and model groups (the ranks of one data index).
Inside ``global_program()`` on a grid every helper above works over this
rank's data group only: the model ranks of a data group hold the same
rows, and a reduce over the whole world would count them again.
``shard_quantizer`` splits the PQ codebooks and their EMA state on K over
the model group, ``shard_backbone`` the ViT MLPs Megatron-style (fc1's
output rows, fc2's input columns), as ``equss_tpu/parallel/mesh.py`` lays
them out; the modules then reduce over the model group themselves, with
``model_sum`` (a sum whose backward is the identity: Megatron's *g*, for
an output that every model rank consumes alike), ``model_sum_sharded`` (a
sum whose consumers are the shards: backward a sum too; Megatron's *f*,
the identity whose backward is a sum, is not needed: the backbone is
frozen, so no gradient reaches a sharded MLP's input), ``model_min_``
(int64 MIN),
``model_max_`` and ``gather_k`` (the (M, K/m[, d]) shards as (M, K[, d]),
bit for bit).  The model-group helpers need no global program: a sharded
module always reduces over the grid's model group.  ``gather_sharded`` and
``take_sharded`` turn a sharded module's tensors into whole ones and back
(``Trainer.state_dict`` / ``load_state_dict``).
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

from equss_tpu_torch.core import trace
from equss_tpu_torch.device import DeviceLike, resolve_device


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


def _broadcast_(t: torch.Tensor, group=None) -> None:
    """The ``t`` of the first rank of ``group`` (default: every rank) into
    ``t``, through the group's device."""
    dev = _comm_device()
    src = 0 if group is None else dist.get_global_rank(group, 0)
    if t.device == dev:
        dist.broadcast(t, src=src, group=group)
    else:
        tmp = t.to(dev)
        dist.broadcast(tmp, src=src, group=group)
        t.copy_(tmp)


# --------------------------------------------------------------- batches
def shard_batch(batch: Dict[str, Any], device: DeviceLike) -> Dict[str, torch.Tensor]:
    """A host batch's numeric arrays on ``device``.  Each rank passes its
    own rows of the global batch, as the data pipeline yields them.
    Entries that are not numeric arrays (the image paths a corpus
    carries) stay host-side: they are left out, as in the JAX package.
    The bytes of each host array moved to another device are added to the
    counter ``h2d_bytes`` (``core.trace``)."""
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            t = v
        elif hasattr(v, "dtype") and np.dtype(v.dtype).kind not in ("U", "S", "O"):
            t = torch.from_numpy(np.asarray(v))
        else:
            continue
        out[k] = t.to(device, non_blocking=True)
        if t.device.type == "cpu" and out[k].device.type != "cpu":
            trace.count("h2d_bytes", t.nbytes)
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


class Grid:
    """A (data, model) grid of the process group's ranks: ``data`` and
    ``model`` its sizes, ``data_index`` and ``model_index`` this rank's
    place, ``data_group`` the ranks of this model index and ``model_group``
    those of this data index (None without a process group)."""

    def __init__(self, data: int, model: int, data_index: int = 0, model_index: int = 0,
                 data_group=None, model_group=None):
        self.data, self.model = data, model
        self.data_index, self.model_index = data_index, model_index
        self.data_group, self.model_group = data_group, model_group

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def __repr__(self) -> str:
        return (f"Grid(data={self.data}, model={self.model}, at=({self.data_index}, "
                f"{self.model_index}))")


_GRID: Optional[Grid] = None


def make_mesh_2d(data: int, model: int) -> Grid:
    """The (data, model) grid over the process group, which becomes this
    process's grid (``grid()``): batch over 'data', the codebook's K axis
    and the MLPs' hidden axis over 'model' (``shard_quantizer``,
    ``shard_backbone``).  Rank r sits at (r // model, r % model).  Every
    rank must call it, with the same sizes: it creates every data group,
    then every model group, in order.  One process is a 1 x 1 grid.
    Raises ``ValueError`` when the group has fewer ranks than the grid,
    or more (every rank holds a place on it)."""
    data, model = int(data), int(model)
    if data < 1 or model < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {data}x{model}")
    n = world()
    if n < data * model:
        raise ValueError(f"requested a {data}x{model} mesh but only {n} rank(s) are in the "
                         f"process group (one process per device)")
    if n > data * model:
        raise ValueError(f"a {data}x{model} mesh leaves {n - data * model} of the {n} ranks "
                         f"without a place; every rank must sit on the grid")
    global _GRID
    if not in_group():
        _GRID = Grid(1, 1)
        return _GRID
    r = rank()
    data_groups = [dist.new_group([i * model + c for i in range(data)]) for c in range(model)]
    model_groups = [dist.new_group([i * model + c for c in range(model)]) for i in range(data)]
    _GRID = Grid(data, model, r // model, r % model, data_groups[r % model],
                 model_groups[r // model])
    return _GRID


def grid() -> Optional[Grid]:
    """This process's grid (``make_mesh_2d``), None before one is made."""
    return _GRID


def model_size() -> int:
    """The ranks of this process's model group (1 without a grid)."""
    return _GRID.model if _GRID is not None else 1


def model_index() -> int:
    """This rank's place in its model group (0 without a grid)."""
    return _GRID.model_index if _GRID is not None else 0


def _model_group():
    if _GRID is None or _GRID.model == 1:
        raise ValueError("a tensor-parallel module needs a grid with a model axis: "
                         "make_mesh_2d(data, model) on every rank first")
    return _GRID.model_group


def _reduce_(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (sum unless ``op``), through
    the group's device."""
    op = dist.ReduceOp.SUM if op is None else op
    dev = _comm_device()
    if t.device == dev:
        dist.all_reduce(t, op=op, group=group)
    else:
        tmp = t.to(dev)
        dist.all_reduce(tmp, op=op, group=group)
        t.copy_(tmp)
    return t


def model_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group in place (outside autograd)."""
    return _reduce_(t, _model_group())


def model_min_(t: torch.Tensor) -> torch.Tensor:
    """The least value of each element over the model group, in place
    (int64 keys: the quantizer's cross-rank first minimum)."""
    return _reduce_(t, _model_group(), dist.ReduceOp.MIN)


def model_max_(t: torch.Tensor) -> torch.Tensor:
    """The greatest value of each element over the model group, in place."""
    return _reduce_(t, _model_group(), dist.ReduceOp.MAX)


def _exact_sum_(t: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of tensors of which every element is
    nonzero on one rank at most, bit for bit: f32 is summed as its int32
    bits, so that a -0.0 stays -0.0."""
    if t.dtype == torch.float32:
        _reduce_(t.view(torch.int32), _model_group())
        return t
    return _reduce_(t, _model_group())


class _ModelSum(torch.autograd.Function):
    """Megatron's g: the sum over the model group; the gradient of the sum,
    which every model rank then consumes alike, is each rank's as it is."""

    @staticmethod
    def forward(ctx, t, exact):
        out = t.detach().clone()
        return _exact_sum_(out) if exact else _reduce_(out, _model_group())

    @staticmethod
    def backward(ctx, g):
        return g, None


def model_sum(t: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """``t`` summed over the model group, differentiable, the backward the
    identity (Megatron's *g*): for partial sums (fc2's products, the
    quantizer's sums over its codewords) whose total every model rank
    consumes alike.  ``exact``: the parts are disjoint (one rank nonzero
    per element) and their sum keeps their bits (``_exact_sum_``)."""
    return _ModelSum.apply(t, exact)


class _ModelSumSharded(torch.autograd.Function):
    """The sum over the model group whose consumers are the ranks' own
    shards: forward and backward both sum."""

    @staticmethod
    def forward(ctx, t):
        return _reduce_(t.detach().clone(), _model_group())

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.contiguous().clone(), _model_group())


def model_sum_sharded(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group, differentiable, for a total that
    each rank then applies to its own shard (a softmax's denominator, the
    codebook's mean over K): the gradient is summed too."""
    return _ModelSumSharded.apply(t)


class _GatherK(torch.autograd.Function):
    """The model ranks' K shards (axis 1) concatenated in rank order, bit
    for bit; the gradient of a rank's shard is its slice of the gradient
    it took at the whole (every model rank consumes the whole alike)."""

    @staticmethod
    def forward(ctx, t):
        m, r = model_size(), model_index()
        k = t.shape[1]
        full = t.new_zeros((t.shape[0], k * m, *t.shape[2:]))
        full[:, r * k:(r + 1) * k] = t.detach()
        ctx.k = k
        return _exact_sum_(full)

    @staticmethod
    def backward(ctx, g):
        r, k = model_index(), ctx.k
        return g[:, r * k:(r + 1) * k]


def gather_k(t: torch.Tensor) -> torch.Tensor:
    """The whole (M, K[, d]) tensor of the model ranks' (M, K/m[, d]) shards,
    differentiable (``_GatherK``)."""
    return _GatherK.apply(t)


def take_k(t: torch.Tensor) -> torch.Tensor:
    """This model rank's shard (axis 1) of a whole (M, K[, d]) tensor."""
    m, r = model_size(), model_index()
    k = t.shape[1] // m
    return t[:, r * k:(r + 1) * k]


# ----------------------------------------------------- the sharded layouts
QUANTIZER_LEAVES = {"codebook": 3, "ema_weight": 3, "ema_weight_avg": 3,
                    "ema_count": 2, "vq_count": 2}      # leaf name: rank, split on K


def _quantizer_dim(name: str, t: torch.Tensor) -> Optional[int]:
    """The axis JAX's ``shard_quantizer`` splits a leaf on (K: 1), or None."""
    return 1 if QUANTIZER_LEAVES.get(name.rsplit(".", 1)[-1]) == t.ndim else None


def _backbone_dim(name: str, t: torch.Tensor, tp: int) -> Optional[int]:
    """The axis JAX's ``shard_backbone`` splits a leaf on, in the port's
    (out, in) ``Dense`` layout: fc1's weight rows and bias (its output),
    fc2's weight columns (its input), where the hidden width divides by
    ``tp``; None for everything else (qkv and proj among them)."""
    parts = name.split(".")
    if len(parts) < 3 or parts[-3] != "mlp":
        return None
    layer, leaf = parts[-2], parts[-1]
    if layer == "fc1" and leaf in ("weight", "bias") and t.shape[0] % tp == 0:
        return 0
    if layer == "fc2" and leaf == "weight" and t.ndim == 2 and t.shape[1] % tp == 0:
        return 1
    return None


def _split(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    k = t.shape[dim] // parts
    return t.narrow(dim, index * k, k).contiguous()


def _shard_module(module: nn.Module, dim_of: Callable[[str, torch.Tensor], Optional[int]]
                  ) -> nn.Module:
    """Each parameter and buffer of ``module`` that ``dim_of`` splits
    becomes this model rank's part in place (the tensor objects stay, so
    optimizers keep them); its axis goes into ``module.tp_layout`` by
    state-dict name and onto the tensor as ``tp_dim``."""
    m, r = model_size(), model_index()
    layout = getattr(module, "tp_layout", None)
    if layout is None:
        layout = module.tp_layout = {}
    named = list(module.named_parameters()) + list(module.named_buffers())
    with torch.no_grad():
        for name, t in named:
            if name in layout:
                continue
            dim = dim_of(name, t)
            if dim is None:
                continue
            t.data = _split(t.data, dim, m, r)
            t.tp_dim = dim
            layout[name] = dim
    return module


def _check_k(num_k: int, name: str) -> None:
    if num_k % model_size():
        raise ValueError(f"{name}: K = {num_k} does not divide over the {model_size()} "
                         f"ranks of the model axis")


def shard_quantizer(mesh: Grid, params: Any, model_state: Optional[Dict[str, Any]] = None):
    """The PQ codebooks split on K over the grid's model axis, JAX's rule
    (``equss_tpu/parallel/mesh.py:167-188``): leaves named ``codebook``,
    ``ema_weight`` and ``ema_weight_avg`` (3-D) and ``ema_count`` and
    ``vq_count`` (2-D) keep this model rank's K / model codewords, in rank
    order; everything else stays whole.  K % model != 0 raises
    ``ValueError``.

    ``shard_quantizer(mesh, params, model_state)`` takes and returns
    nested dicts, as JAX's; ``shard_quantizer(mesh, model)`` shards the
    module's quantizer tensors in place and returns it (the port's idiom:
    ``pq_forward`` then runs on the shards)."""
    _check_mesh(mesh)
    if isinstance(params, nn.Module):
        for name, t in list(params.named_parameters()) + list(params.named_buffers()):
            if _quantizer_dim(name, t) is not None:
                _check_k(t.shape[1], name)
        return _shard_module(params, _quantizer_dim)

    def place(tree, prefix=""):
        if torch.is_tensor(tree):
            dim = _quantizer_dim(prefix, tree)
            if dim is None or mesh.model == 1:
                return tree
            _check_k(tree.shape[1], prefix)
            return _split(tree, dim, mesh.model, mesh.model_index)
        if isinstance(tree, dict):
            return {k: place(v, f"{prefix}.{k}" if prefix else str(k)) for k, v in tree.items()}
        return tree

    return place(params), place(model_state)


def shard_backbone(mesh: Grid, params: Any):
    """Megatron-style tensor parallelism for the ViT MLPs over the model
    axis, JAX's rule (``equss_tpu/parallel/mesh.py:191-232``) in the port's
    (out, in) ``Dense`` layout: each block's fc1 keeps hidden / model of its
    output rows (weight and bias), fc2 the same columns of its input, where
    hidden divides by model; everything else, qkv and proj included, stays
    whole.  ``models/vit.py::Mlp`` then sums fc2's partial products over
    the model group in f32, rounds once to the compute dtype and adds the
    bias once.  A state dict (name -> tensor) gives a new dict; a module is
    sharded in place and returned."""
    _check_mesh(mesh)
    tp = mesh.model
    if isinstance(params, nn.Module):
        return _shard_module(params, lambda name, t: _backbone_dim(name, t, tp))
    out = {}
    for name, t in params.items():
        dim = _backbone_dim(name, t, tp) if tp > 1 else None
        out[name] = t if dim is None else _split(t, dim, tp, mesh.model_index)
    return out


def _check_mesh(mesh: Grid) -> None:
    if mesh is not _GRID:
        raise ValueError("shard over this process's grid: the one make_mesh_2d returned")


def sharded_layout(module: nn.Module) -> Dict[str, int]:
    """A module's sharded tensors by state-dict name and the axis each is
    split on (empty for a module that holds every tensor whole)."""
    return dict(getattr(module, "tp_layout", {}) or {})


def gather_sharded(tensors: Dict[str, torch.Tensor], layout: Dict[str, int]
                   ) -> Dict[str, torch.Tensor]:
    """Whole tensors of a sharded module's (``sharded_layout``), every
    model rank's parts concatenated on their axis in rank order, bit for
    bit; the other entries as they are."""
    out = dict(tensors)
    m = model_size()
    for name, dim in layout.items():
        if name not in out or m == 1:
            continue
        t = out[name].detach()
        k = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = k * m
        full = t.new_zeros(shape)
        full.narrow(dim, model_index() * k, k).copy_(t)
        out[name] = _exact_sum_(full)
    return out


def take_sharded(tensors: Dict[str, torch.Tensor], layout: Dict[str, int],
                 local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This model rank's parts of whole tensors: each entry of ``layout``
    whose shape is not its ``local`` tensor's is split on its axis; the
    other entries as they are."""
    out = dict(tensors)
    for name, dim in layout.items():
        if name in out and name in local and out[name].shape != local[name].shape:
            out[name] = _split(out[name], dim, model_size(), model_index())
    return out


# ------------------------------------------------------ the global program
class _Program:
    """The ranks a ``global_program()`` runs over: ``group`` (None: every
    rank), of ``size`` ranks, this one at ``index``."""

    def __init__(self, size: int, index: int, group=None):
        self.world, self.rank, self.group = size, index, group


_PROGRAM: Optional[_Program] = None


@contextlib.contextmanager
def global_program():
    """Run the enclosed code as the ranks' share of one global program:
    inside, the helpers below reduce and gather over the group's ranks.
    Every rank must enter it and issue the same collectives in the same
    order, which the same program on the same shapes does.  On a grid
    (``make_mesh_2d``) the program's ranks are this rank's data group.
    Without a group it changes nothing."""
    global _PROGRAM
    prev = _PROGRAM
    if not in_group():
        _PROGRAM = None
    elif _GRID is not None and _GRID.data_group is not None:
        _PROGRAM = _Program(_GRID.data, _GRID.data_index, _GRID.data_group)
    else:
        _PROGRAM = _Program(world(), rank())
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
    """Sum ``t`` over the program's ranks in place, through the group's
    device."""
    return _reduce_(t, _PROGRAM.group)


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
        _broadcast_(t, _PROGRAM.group)
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
