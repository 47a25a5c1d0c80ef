"""A (data, model) mesh over the processes of a ``torch.distributed``
group, and the collectives of the port's data- and tensor-parallel paths
(counterpart of the JAX package's ``parallel/mesh.py``).

JAX lays arrays out over a device mesh and lets its SPMD partitioner insert
the collectives.  Here each process drives one device (one process per GPU,
as ``torchrun --nproc-per-node N`` starts them) and the collectives are
explicit.  Process ``d * n_model + m`` sits at data index d and model index
m (JAX's ``make_mesh`` reshapes its devices so).

- Data axis: a caller takes its rows of a global batch (:func:`local_rows`),
  averages a flat tensor over the data axis (:func:`mean_`), gathers every
  rank's rows in rank order (:func:`gather_rows`).
- Model axis (tensor parallelism): a layer that JAX shards over ``model``
  runs on this rank's share of its output channels or heads, between
  Megatron's pair of autograd functions: :func:`copy_to_model` (identity
  forward, gradient summed over the model axis) in front,
  :func:`gather_channels` (channels gathered forward, this rank's slice
  backward) or :func:`reduce_from_model` (summed forward, identity
  backward) behind, their collectives in ``torch.profiler`` ranges
  ``tp/all_gather`` and ``tp/all_reduce``.  :func:`tp_sharded` is JAX's
  ``_tp_spec`` rule on the port's parameter names.
- :func:`replicate_tree` broadcasts from rank 0 of both axes.

Without a process group a mesh has one rank and every collective is the
identity.  Backends: NCCL for CUDA tensors, gloo for CPU tensors; gloo with
CUDA tensors is the one-card check of a several-rank path (NCCL refuses two
ranks on one device).  The helpers call the same collectives on either:
gloo reduces, broadcasts and gathers CUDA tensors itself (PyTorch 2.11 on
the H100 machine), so nothing is copied through the host.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..utils.device import resolve_device

def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if is_distributed() else 0


def multihost_init(device=None) -> None:
    """Join the process group that ``torchrun`` describes.

    A no-op unless its environment says there are several processes
    (``WORLD_SIZE`` > 1) and no group exists yet, so the same entry points
    serve one process and many.  The backend follows ``device`` (default:
    the GPU): NCCL on CUDA, with this process pinned to
    ``cuda:LOCAL_RANK``, gloo on the CPU.  Nothing is retried on another
    backend."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or is_distributed():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data`` x ``n_model`` processes.  ``group`` is this process's data
    axis (the ranks of its model index) and ``rank`` its index there;
    ``model_group`` is its model axis (the ranks of its data index) and
    ``model_rank`` its index there.  An axis of one rank has no group
    (None): its collectives are the identity."""

    n_data: int
    n_model: int = 1
    group: Optional[object] = None
    rank: int = 0
    model_group: Optional[object] = None
    model_rank: int = 0

    def __post_init__(self):
        # an axis of several ranks without their group would keep one
        # rank's share of every batch (or channel) and reduce nothing
        for n, group, rank in ((self.n_data, self.group, self.rank),
                               (self.n_model, self.model_group,
                                self.model_rank)):
            if n > 1 and group is None:
                raise ValueError(f"mesh {self.n_data}x{self.n_model} needs a "
                                 f"process group (torchrun, or "
                                 f"multihost_init)")
            if not 0 <= rank < n:
                raise ValueError(f"rank {rank} is outside the "
                                 f"{self.n_data}x{self.n_model} mesh")

    @property
    def data_rank(self) -> int:
        return self.rank

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices``, by default every process of
    the default group (one device each); ``n_data`` defaults to all of them
    over ``n_model``, and a smaller mesh takes the first ``n_data *
    n_model`` processes.  Called by every process of the group when there
    is one: each builds every axis's group in the same order, and a process
    outside the mesh then raises."""
    devs = list(devices if devices is not None else range(world_size()))
    if n_data is None:
        n_data = len(devs) // n_model
    # JAX's two assertion messages, raised as errors
    if not (n_data >= 1 and n_model >= 1):
        raise ValueError(
            f"mesh {n_data}x{n_model} is empty — n_model={n_model} exceeds the "
            f"{len(devs)} visible devices")
    if n_data * n_model > len(devs):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices but only "
            f"{len(devs)} are visible")
    if not is_distributed():
        return Mesh(n_data, n_model)
    world, me = dist.get_world_size(), dist.get_rank()

    def group(ranks):
        if ranks == list(range(world)):
            return dist.group.WORLD
        return dist.new_group(ranks) if len(ranks) > 1 else None

    data_groups = [group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    if me >= n_data * n_model:
        raise ValueError(
            f"process {me} of {world} is outside the {n_data}x{n_model} mesh "
            f"(ranks 0-{n_data * n_model - 1}): start {n_data * n_model} "
            f"processes, or a mesh that takes all {world}")
    d, m = divmod(me, n_model)
    return Mesh(n_data, n_model, data_groups[m], d, model_groups[d], m)


def check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), "
                        f"not {type(mesh).__name__}")
    return mesh


def local_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous share of ``x``'s leading axis (the
    counterpart of ``shard_batch``): rows ``[r*b, (r+1)*b)`` with b =
    len(x) / n_data, which must be whole."""
    n, B = mesh.n_data, x.shape[0]
    if B % n:
        raise ValueError(f"{B} rows do not split evenly over {n} "
                         f"data-parallel ranks")
    b = B // n
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def mean_(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Average ``x`` over the data axis in place (every rank gets the same
    values); returns ``x``."""
    if mesh.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.AVG, group=mesh.group)
    return x


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (each of the same shape) concatenated along the
    leading axis in rank order, on every rank."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def replicate_tree(tree, mesh: Mesh):
    """Broadcast every tensor of ``tree`` (a tensor, a module's parameters
    and buffers, or dicts / lists / tuples of them; None passes) from rank
    0 of the data axis, then from rank 0 of the model axis, in place, so
    that every process of the mesh holds process 0's values; returns
    ``tree``."""
    for group in (mesh.group, mesh.model_group):
        if group is not None:
            _broadcast_tree(tree, group)
    return tree


def _broadcast_tree(tree, group) -> None:
    src = dist.get_global_rank(group, 0)

    def walk(node):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            dist.broadcast(node.data, src, group=group)
        elif isinstance(node, torch.nn.Module):
            for t in list(node.parameters()) + list(node.buffers()):
                walk(t)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            raise TypeError(f"cannot replicate a {type(node).__name__}")

    walk(tree)


def shard_params_tp(params, mesh: Mesh):
    """JAX's name for laying the weights over the mesh.  The port keeps
    every parameter whole and equal on every process (this is
    :func:`replicate_tree`) and splits the work instead: a layer that
    :func:`tp_sharded` marks runs on this rank's share of its channels or
    heads (``UNet1D.tensor_parallel``).  Whole storage costs little (the
    attn16k model is 5.3 MB in f32), JAX keeps the optimizer state whole
    too, and it leaves the flat parameter buffer, optax's state layout, the
    bad-batch gate and the checkpoints as they are at tp = 1."""
    return replicate_tree(params, mesh)


# the narrowest last axis that JAX's ``_tp_spec`` shards (its ``min_ch``
# default, which its trainer never changes)
TP_MIN_CH = 16


def tp_sharded(name: str, shape: Sequence[int], n_model: int) -> bool:
    """JAX's ``_tp_spec`` rule for the parameter ``name`` (the port's
    dotted name, the flax path) of ``shape``: sharded over its last axis
    when the model axis is above 1, that axis splits evenly and is at
    least ``TP_MIN_CH`` wide, the path passes an enc / dec / mid module and
    no norm."""
    parts = name.split(".")
    return (n_model > 1 and len(shape) >= 1 and shape[-1] % n_model == 0
            and shape[-1] >= TP_MIN_CH
            and any(p.startswith(("enc", "dec", "mid")) for p in parts)
            and not any("norm" in p.lower() for p in parts))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        with record_function("tp/all_reduce"):
            dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(n)]
        with record_function("tp/all_gather"):
            dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        with record_function("tp/all_reduce"):
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every model rank) as the input of a model-split
    layer: the identity forward; backward, the gradient summed over the
    model axis (each rank's layer saw only its part of x's uses)."""
    if mesh.model_group is None:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def gather_channels(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every model rank's ``x`` (its share of the channels, the last axis)
    concatenated in rank order, on every model rank; backward, this rank's
    slice of the gradient."""
    if mesh.model_group is None:
        return x
    return _GatherChannels.apply(x, mesh.model_group, mesh.n_model,
                                 mesh.model_rank)


def reduce_from_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every model rank's ``x`` (its partial result), on every
    model rank; backward, the identity."""
    if mesh.model_group is None:
        return x
    return _ReduceFromModel.apply(x, mesh.model_group)


def sum_model_(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the model axis in place; returns ``x``."""
    if mesh.model_group is not None:
        dist.all_reduce(x, group=mesh.model_group)
    return x


def barrier() -> None:
    """Wait for every process of the default group (none: returns)."""
    if is_distributed():
        dist.barrier()


def rank0_writes(args, *names: str) -> None:
    """Ranks above 0 run the same program as rank 0 (JAX's multi-controller
    model), but only rank 0 writes the program's files: on the other ranks
    each path attribute of ``args`` in ``names`` that is set is pointed
    into a temporary directory, removed when the process exits."""
    rank = process_index()
    if rank == 0:
        return
    d = tempfile.mkdtemp(prefix=f"gw-rank{rank}-")
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    for name in names:
        if getattr(args, name, None):
            setattr(args, name, os.path.join(d, name))
