"""The device mesh and its sharding rules (counterpart of
``surs_tpu/parallel/mesh.py``).

Two axes, as in the JAX package:

  * ``data``: the batch axis of training steps and of batched
    reconstruction; gradients are summed over it;
  * ``points``: the query-point axis of grid evaluation and the x-slabs
    of sharded extraction.

The port runs one process per rank (``launch.py``, or ``torchrun``). A
:class:`Mesh` is that rank's view: each axis's size, the rank's
coordinate on it and the :class:`~.comm.Comm` of the ranks that share
its other coordinate. Under a process group the axes are the dims of a
``torch.distributed.device_mesh.DeviceMesh``; with no group, ``make_mesh``
gives the one-rank mesh over the current device. A sharding is a
``PartitionSpec``-like tuple naming, per tensor dim, the axis it is
split over; :func:`shard` takes this rank's block of a whole tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .comm import Comm, DistComm, LocalComm

DATA_AXIS = "data"
POINT_AXIS = "points"
AXES = (DATA_AXIS, POINT_AXIS)


@dataclass(frozen=True)
class Mesh:
    """This rank's view of an [n_data, n_points] mesh."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    comms: Dict[str, Comm]
    world: Comm
    device: torch.device
    device_mesh: Any = field(default=None, compare=False)
    axis_names: Tuple[str, str] = AXES

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def comm(self, axis: str) -> Comm:
        return self.comms[axis]

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def is_root(self) -> bool:
        """Rank 0 of the world: the rank that prints and writes files."""
        return self.world.rank == 0


def local_mesh(device=None) -> Mesh:
    """The one-rank mesh over ``device`` (default: the current CUDA
    device, else the CPU)."""
    one = LocalComm()
    return Mesh({a: 1 for a in AXES}, {a: 0 for a in AXES},
                {a: one for a in AXES}, one, _device(device))


def mesh_of(comms: Dict[str, Comm], world: Comm, device) -> Mesh:
    """A mesh from per-axis comms (a thread run's, ``launch.py``)."""
    return Mesh({a: comms[a].size for a in AXES},
                {a: comms[a].rank for a in AXES}, comms, world,
                torch.device(device))


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_data: Optional[int] = None, n_points: int = 1,
              device_type: Optional[str] = None) -> Mesh:
    """The [n_data, n_points] mesh over every rank of the process group
    (``n_data`` defaults to world / n_points), or, with no group, the
    one-rank mesh. ``device_type`` 'cuda' without a GPU raises."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda'): no CUDA device")
    if not (dist.is_available() and dist.is_initialized()):
        if (n_data or 1) * n_points != 1:
            raise ValueError(
                f"a {n_data}x{n_points} mesh needs a process group of "
                f"{(n_data or 1) * n_points} ranks; none is initialised")
        dev = torch.device("cpu") if device_type == "cpu" else _device(None)
        return local_mesh(dev)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_points
    if n_data * n_points != world:
        raise ValueError(f"{n_data}x{n_points} != {world} ranks")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    # a DeviceMesh makes its groups collectively: one per shape and group
    key = (id(dist.distributed_c10d._get_default_group()), n_data,
           n_points, device_type)
    if key not in _MESHES:
        _MESHES[key] = _dist_mesh(n_data, n_points, device_type)
    return _MESHES[key]


_MESHES: Dict = {}


def _dist_mesh(n_data: int, n_points: int, device_type: str) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device_type, (n_data, n_points),
                          mesh_dim_names=AXES)
    comms = {a: DistComm(dm.get_group(a)) for a in AXES}
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    return Mesh({a: n for a, n in zip(AXES, (n_data, n_points))},
                {a: comms[a].rank for a in AXES}, comms,
                DistComm(dist.group.WORLD), device, dm)


class Sharding(NamedTuple):
    """Per tensor dim, the mesh axis it is split over (None: whole on
    every rank), like ``jax.sharding.PartitionSpec`` over ``mesh``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def batch_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Dim 0 (the batch) over ``data``, the rest whole."""
    return Sharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def point_sharding(mesh: Mesh, axis: int, ndim: int) -> Sharding:
    """Dim ``axis`` (the points of a query tensor) over ``points``."""
    spec = [None] * ndim
    spec[axis] = POINT_AXIS
    return Sharding(mesh, tuple(spec))


def shard(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``x``; a split dim must
    divide by its axis's size."""
    for dim, axis in enumerate(sharding.spec):
        if axis is None:
            continue
        n, i = sharding.mesh.size(axis), sharding.mesh.index(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide by the {axis!r} axis' {n} ranks")
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every tensor of a training batch, on the
    mesh's device; the batch must divide by the ``data`` axis."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        out[k] = shard(v, batch_sharding(mesh, v.dim())).to(mesh.device)
    return out


def replicate_tree(tree, mesh: Mesh):
    """Rank 0's values on every rank: a module's parameters and buffers
    (in place; returns the module) or a dict of tensors (a new dict)."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                mesh.world.broadcast(t.data)
        return tree
    return {k: mesh.world.broadcast(torch.as_tensor(v).clone())
            for k, v in tree.items()}
