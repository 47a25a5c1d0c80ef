"""A (data, model) mesh over the processes of a ``torch.distributed``
group, and the collectives the port's data-parallel paths need
(counterpart of the JAX package's ``parallel/mesh.py``).

JAX lays arrays out over a device mesh and lets its SPMD partitioner insert
the collectives.  Here each process drives one device (one process per GPU,
as ``torchrun --nproc-per-node N`` starts them) and the collectives are
explicit: a data-parallel caller takes its rows of a global batch
(:func:`local_rows`), averages a flat tensor over the data axis
(:func:`mean_`), gathers every rank's rows in rank order
(:func:`gather_rows`) and broadcasts from data rank 0
(:func:`replicate_tree`).  Without a process group a mesh has one rank and
every collective is the identity.

Backends: NCCL for CUDA tensors, gloo for CPU tensors; gloo with CUDA
tensors is the one-card check of a several-rank path (NCCL refuses two
ranks on one device).  The helpers call the same collectives on either:
gloo reduces, broadcasts and gathers CUDA tensors itself (PyTorch 2.11 on
the H100 machine), so nothing is copied through the host.

Not here yet: tensor parallelism (a ``model`` axis above 1: building a
:class:`Mesh` with one raises), ``ROADMAP.md`` P10.1.
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

from ..utils.device import resolve_device

TP_TODO = ("tensor parallelism (--tp > 1, a mesh 'model' axis above 1) is "
           "not ported yet: ROADMAP.md P10.1 (tensor parallelism)")


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
    """``n_data`` x ``n_model`` processes; ``group`` is this process's data
    axis (None without a process group) and ``rank`` its index there."""

    n_data: int
    n_model: int = 1
    group: Optional[object] = None
    rank: int = 0

    def __post_init__(self):
        # a data axis of several ranks without their group would keep one
        # rank's share of every batch and average nothing
        if self.n_model > 1:
            raise NotImplementedError(TP_TODO)
        if self.n_data > 1 and self.group is None:
            raise ValueError(f"mesh {self.n_data}x1 needs a process group "
                             f"(torchrun, or multihost_init)")
        if not 0 <= self.rank < self.n_data:
            raise ValueError(f"rank {self.rank} is outside the "
                             f"{self.n_data}x1 mesh")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices``, by default every process of
    the default group (one device each); ``n_data`` defaults to all of them
    on the data axis, and a smaller one takes the first ``n_data``.  A
    model axis above 1 raises (tensor parallelism is not ported).  Called
    by every process of the group when there is one."""
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
    group = (dist.group.WORLD if n_data == dist.get_world_size()
             else dist.new_group(list(range(n_data))))
    return Mesh(n_data, n_model, group, dist.get_rank())


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
    and buffers, or dicts / lists / tuples of them; None passes) from data
    rank 0 to the other ranks, in place; returns ``tree``."""
    if mesh.group is None:
        return tree
    src = dist.get_global_rank(mesh.group, 0)

    def walk(node):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            dist.broadcast(node.data, src, group=mesh.group)
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
    return tree


def shard_params_tp(params, mesh: Mesh):
    """JAX's name for laying the weights over the mesh.  A :class:`Mesh`
    has a model axis of 1 until tensor parallelism is ported (P10.1), so
    this is :func:`replicate_tree`, as JAX's degenerates to at tp = 1."""
    return replicate_tree(params, mesh)


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
