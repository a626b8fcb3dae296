"""Meshes of ranks with named axes.

Counterpart of ``ray_tpu/sharding/mesh.py:31-117`` (``data_axis``,
``num_shards``, ``model_axis``, ``model_shards``, the ``"batch"`` and ``"model"`` axis
names; its ``get_mesh`` is :func:`make_mesh` with
``[("batch", n)]``) and ``ray_tpu/parallel/mesh.py:20-52``
(``make_mesh``, ``num_data_shards``, ``DATA_AXIS``, ``MODEL_AXIS``). In
JAX a mesh is an array of devices and an axis name is all a collective
needs. Here a rank is a process, a mesh arranges the ranks of the
default process group in a row-major grid, and each axis maps to the
process group of the ranks along it: the collectives of
:mod:`ray_tpu_torch.parallel.collectives` take that group.

:class:`Mesh` is a thin class rather than
``torch.distributed.device_mesh.DeviceMesh`` on purpose. DeviceMesh binds
its device type to the groups it builds: for ``"cuda"`` it may create a
new group on the card's default backend (NCCL) instead of taking the
gloo world group, and it picks the current card by its own heuristic.
The one-card ring runs several ranks on one card over gloo with CUDA
tensors, which NCCL refuses, so the mesh keeps the backend of
:func:`~ray_tpu_torch.parallel.distributed.initialize` for every axis;
the transport of a hop then follows that backend (NCCL moves CUDA
tensors directly, gloo stages them through host memory: see
:mod:`ray_tpu_torch.parallel.collectives`).

Unlike the reference's ``available_devices`` there is no CPU fallback:
without a CUDA device and without ``device="cpu"``, :func:`make_mesh`
raises (through :func:`ray_tpu_torch.device.resolve_device`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.device import resolve_device

DATA_AXIS = "data"  # the legacy parallel.mesh axis
BATCH_AXIS = "batch"  # the sharding runtime's data axis
MODEL_AXIS = "model"


class Mesh:
    """Ranks in a row-major grid of named axes. ``shape`` maps each axis
    name to its size, in order (as a JAX mesh's ``shape``); ``device`` is
    where this rank's tensors live."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 groups: Dict[str, dist.ProcessGroup], device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device = device
        self._groups = groups

    def group(self, axis: str) -> dist.ProcessGroup:
        """The process group of this rank's line along ``axis``."""
        if axis not in self._groups:
            raise KeyError(f"mesh axes are {self.axis_names}, not {axis!r}")
        return self._groups[axis]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return dist.get_rank(self.group(axis))


def make_mesh(
    axis_shapes: Optional[Sequence[Tuple[str, int]]] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Mesh:
    """A mesh over every rank of the default process group; the default
    is the 1-D ``("data",)`` mesh. ``axis_shapes`` such as ``[("data", 2),
    ("sp", 4)]`` must multiply to the world size. Every rank must call
    this with the same shapes, in the same order (it creates the axes'
    groups together)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "ray_tpu_torch.parallel.distributed.initialize first"
        )
    n = dist.get_world_size()
    if axis_shapes is None:
        axis_shapes = [(DATA_AXIS, n)]
    names = [name for name, _ in axis_shapes]
    sizes = [int(size) for _, size in axis_shapes]
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh shape {dict(axis_shapes)} needs {math.prod(sizes)} ranks, have {n}"
        )
    grid = torch.arange(n).reshape(sizes)
    me = dist.get_rank()
    groups = {}
    for axis, name in enumerate(names):
        lines = grid.movedim(axis, -1).reshape(-1, sizes[axis]).tolist()
        for ranks in lines:
            # every rank creates every line's group, in the same order
            group = dist.group.WORLD if len(ranks) == n else dist.new_group(ranks)
            if me in ranks:
                groups[name] = group
    return Mesh(names, sizes, groups, dev)


def data_axis(mesh: Mesh) -> str:
    """The data-parallel axis: the mesh's first."""
    return mesh.axis_names[0]


def num_shards(mesh: Mesh) -> int:
    return mesh.size(data_axis(mesh))


num_data_shards = num_shards


def model_axis(mesh: Mesh) -> Optional[str]:
    """``"model"`` when the mesh has that axis, else None."""
    return MODEL_AXIS if MODEL_AXIS in mesh.axis_names else None


def model_shards(mesh: Mesh) -> int:
    """The size of the ``"model"`` axis (1 when the mesh has none)."""
    return mesh.size(MODEL_AXIS) if MODEL_AXIS in mesh.axis_names else 1

