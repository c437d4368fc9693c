"""The (data × model) process mesh (port of ``node2vec_tpu/parallel/mesh.py``).

The JAX package runs one controller over a named-axis device mesh and lets
XLA insert the collectives of its ``shard_map`` programs.  The port runs
one process a rank (SPMD over ``torch.distributed``), and a JAX sharding
becomes which slice a rank holds:

* ``P("data", None)``: this rank's data coordinate's block of rows (walker
  batches, walk corpora: the reference's hash partitions);
* ``P(None, "model")``: its model coordinate's block of columns, dims
  ``[m * D / n_model, (m + 1) * D / n_model)`` of every table row (tensor
  parallelism);
* ``P()``: the whole array on every rank.

Rank ``r`` sits at ``(r // n_model, r % n_model)``, JAX's device grid
``devices.reshape(n_data, n_model)``.  A ``psum`` over an axis becomes
``Mesh.all_reduce_sum`` on that axis's process group: the group of the
ranks that differ from this one only in that coordinate.  The flattened
mesh, JAX's ``("data", "model")`` axis tuple (``Mesh.world``, the mesh's two
axis names together), is every rank in flat order ``d * n_model + m``; its
collectives (the row-sharded trainers' ``all_to_all``, ``psum`` and
``all_gather``) run over the whole process group.  The mesh's helpers are
the only place the port calls a collective.

The backend is the caller's (``initialize_distributed``, or the process
group already initialised).  NCCL carries CUDA tensors as they are.  Gloo
carries CPU tensors; the CUDA tensors it is given are copied to host memory
and back explicitly (``Mesh.host_staged``), whatever collectives the
installed gloo would take on the device.  A failing collective is never
retried on another backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    n_data: int
    n_model: int

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_model


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Multi-process bring-up, once a process, before ``make_mesh``.

    With ``coordinator_address`` ("host:port") the world is
    ``num_processes`` ranks, this one ``process_id``, met over
    ``tcp://``.  With no arguments, torchrun's variables (``MASTER_ADDR``,
    ``RANK``, ``WORLD_SIZE``) are read over ``env://`` when they are set, and
    nothing happens otherwise: a single process, to which ``make_mesh``
    gives a world of one.  A no-op once a process group exists.
    ``backend``: "nccl" or "gloo"; None takes NCCL when CUDA is available.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
        return
    if all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
        dist.init_process_group(backend, init_method="env://")


def _local_device(device) -> torch.device:
    """``device`` with this rank's card when it names CUDA without an index:
    ``LOCAL_RANK`` (or the rank) modulo the cards of the host."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """This rank's place in a (data × model) mesh and the axes' groups.

    ``shape``: {"data": n_data, "model": n_model}, read as the JAX mesh's;
    ``coords``: this rank's {"data": d, "model": m}; ``device``, ``backend``.
    An axis is one of the two names, or ``world`` (both names as a tuple,
    the flattened mesh; the rank's flat index there is ``rank``).
    ``collectives`` counts the calls by (op, axis).
    """

    def __init__(self, n_data: int, n_model: int, axis_names: Tuple[str, str],
                 device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {axis_names[0]: n_data, axis_names[1]: n_model}
        self.rank = dist.get_rank()
        self.coords = {axis_names[0]: self.rank // n_model, axis_names[1]: self.rank % n_model}
        self.device = device
        self.backend = dist.get_backend()
        self.host_staged = self.backend == "gloo" and device.type == "cuda"
        self.collectives: Dict[Tuple[str, str], int] = {}
        # every rank creates every group, in one order (dist.new_group's rule)
        groups = {}
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            groups[(axis_names[0], m)] = dist.new_group(ranks)
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            groups[(axis_names[1], d)] = dist.new_group(ranks)
        self._groups = {
            axis_names[0]: groups[(axis_names[0], self.coords[axis_names[1]])],
            axis_names[1]: groups[(axis_names[1], self.coords[axis_names[0]])],
        }

    @property
    def world(self) -> Tuple[str, str]:
        """The flattened mesh's axis: JAX's ``("data", "model")``."""
        return self.axis_names

    @property
    def n_devices(self) -> int:
        return self.shape[self.axis_names[0]] * self.shape[self.axis_names[1]]

    def size(self, axis) -> int:
        """The number of ranks along ``axis`` (a name, or ``world``)."""
        return self.n_devices if self._is_world(axis) else self.shape[axis]

    def _is_world(self, axis) -> bool:
        return not isinstance(axis, str) and tuple(axis) == self.axis_names

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, coords={self.coords}, backend={self.backend!r}, "
                f"device={self.device})")

    def _group(self, op: str, axis):
        if self._is_world(axis):
            axis = self.axis_names
            group = None  # every rank is in the mesh: the default group
        elif isinstance(axis, str) and axis in self._groups:
            group = self._groups[axis]
        else:
            raise ValueError(f"unknown mesh axis {axis!r}; the axes are {self.axis_names} "
                             f"and {self.axis_names} together")
        self.collectives[(op, axis)] = self.collectives.get((op, axis), 0) + 1
        return group

    def all_reduce_sum(self, t: torch.Tensor, axis) -> torch.Tensor:
        """``psum(t, axis)`` in place on ``t``; returns ``t``."""
        group = self._group("all_reduce", axis)
        if self.host_staged and t.is_cuda:
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
        """The axis's ranks' tensors of ``t``'s shape, concatenated along
        ``dim`` in coordinate order (a ``P(axis)`` array read back whole)."""
        group = self._group("all_gather", axis)
        src = t.contiguous()
        if self.host_staged and src.is_cuda:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size(axis))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    def all_to_all(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """``lax.all_to_all(t, axis, split_axis=0, concat_axis=0,
        tiled=True)``: ``t``'s first dim in ``size(axis)`` equal blocks,
        block j sent to the axis's rank j; returns the blocks received, in
        rank order (block j from rank j).  ``axis`` defaults to ``world``."""
        axis = self.world if axis is None else axis
        group = self._group("all_to_all", axis)
        if t.shape[0] % self.size(axis):
            raise ValueError(f"all_to_all: dim 0 ({t.shape[0]}) not divisible by "
                             f"{self.size(axis)} ranks")
        src = t.contiguous()
        if self.host_staged and src.is_cuda:
            host = src.cpu()
            out = torch.empty_like(host)
            dist.all_to_all_single(out, host, group=group)
            return out.to(t.device)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return out

    def barrier(self) -> None:
        dist.barrier()


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    device="cuda",
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    """A 2-D (data × model) mesh over the ranks of the process group.

    Defaults: every rank on the data axis.  ``n_data=None`` derives it from
    the world size and ``n_model``.  Every rank takes part (each process
    runs the program on its own slice): a mesh needing more ranks than the
    world has, or leaving some out, is a ``ValueError``.  With no process
    group yet, this process becomes a world of one ("nccl" for a CUDA
    device, "gloo" for the CPU), as ``make_mesh()`` on one device gives a
    1 × 1 mesh in JAX.  ``device``: "cuda" takes this rank's card
    (``LOCAL_RANK``, or the rank, modulo the cards) and makes it current.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a gloo mesh on the CPU")
    if not dist.is_initialized():
        dist.init_process_group(_default_backend(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if n_data is None:
        if n % n_model != 0:
            raise ValueError(f"{n} ranks not divisible by n_model={n_model}")
        n_data = n // n_model
    if n_data * n_model > n:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, have {n}")
    if n_data * n_model < n:
        raise ValueError(f"mesh {n_data}x{n_model} leaves {n - n_data * n_model} of {n} ranks "
                         "out: every rank runs the program on a coordinate of its own")
    dev = _local_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(n_data, n_model, axis_names, dev)
