"""Meshes (port of ``repro/launch/mesh.py``) on ``torch.distributed``.

* :func:`make_abstract_mesh` -- a plain record of axis names and sizes,
  with no devices and no process group: what the sharding rules and the
  planners take, as the JAX package's ``AbstractMesh``.
* :func:`make_host_mesh` / :func:`make_production_mesh` -- a
  ``DeviceMesh`` (``init_device_mesh``) over the process group as it
  stands, one rank a device.  With no process group, a ``(1, 1)`` host
  mesh first sets up a world of one: NCCL on the card, gloo only when the
  caller passes ``device="cpu"``.  A mesh of more ranks needs the caller's
  ``init_process_group`` (its address, world size and rank), and raises
  when the world does not have the mesh's size.
* :func:`dp_axes` -- the data-parallel axes, ``("pod", "data")`` or
  ``("data",)``; :func:`axis_sizes`, :func:`dp_size` and
  :func:`dp_index` read either kind of mesh.

Functions, never module constants: importing this module touches no
process group and no device.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.dispatch import default_device

__all__ = ["AbstractMesh", "make_abstract_mesh", "make_host_mesh",
           "make_production_mesh", "dp_axes", "axis_sizes", "dp_size",
           "dp_index", "mesh_coordinate"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: ``shape`` maps name -> size."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.axis_sizes))


def make_abstract_mesh(shape: Sequence[int],
                       axis_names: Sequence[str]) -> AbstractMesh:
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                         f"{tuple(axis_names)} differ in length")
    return AbstractMesh(tuple(axis_names), tuple(int(s) for s in shape))


def _world_of_one(dev: torch.device) -> None:
    """A process group of one rank on ``dev``: NCCL on the card, gloo on
    the CPU, over an in-memory store (no file, no port)."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device):
    from torch.distributed.device_mesh import init_device_mesh

    dev = default_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a {shape} mesh needs a process group of {n} ranks: call "
                "torch.distributed.init_process_group first")
        _world_of_one(dev)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` ``DeviceMesh`` over the process group (tests,
    examples; a world of one is set up when there is none)."""
    return _device_mesh((data, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")``: the JAX package's pod shapes, over a process group
    of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, names, device)


def axis_sizes(mesh) -> Dict[str, int]:
    """name -> size of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh: ``("pod", "data")`` or
    ``("data",)``."""
    return tuple(a for a in _names(mesh) if a in ("pod", "data"))


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def mesh_coordinate(mesh) -> Dict[str, int]:
    """This rank's index along each axis of a ``DeviceMesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def dp_index(mesh) -> int:
    """This rank's data shard: its data coordinates flattened in axis
    order (``pod`` major), as ``shard_map`` numbers a ``P(dp)`` split."""
    coord, sizes = mesh_coordinate(mesh), axis_sizes(mesh)
    shard = 0
    for ax in dp_axes(mesh):
        shard = shard * sizes[ax] + coord[ax]
    return shard
