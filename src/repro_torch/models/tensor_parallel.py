"""Tensor parallelism over the mesh's `model` axis: the collectives that
take the place of GSPMD's.

The JAX engine places its weights by ``param_shardings(decode=True)`` and
lets the compiler insert the collectives; the port's forward holds plain
local tensors (each rank's shards, ``launch.shardings.local_params``) and
calls them itself, on the process group of the ranks that share its data
shard (``mesh.get_group("model")``):

* ``all_reduce`` sums the partial products of a row-parallel layer (and of
  a tied LM head over a d_model-sharded table); 16-bit partials are
  summed in float32 and rounded once;
* ``all_gather`` joins column blocks along the last dim: a d_model-sharded
  embedding lookup, the input of a row-parallel layer whose adapter reads
  all of it (QuanTA), an untied LM head's vocab columns.

Only these two: gloo, the backend of the CPU ranks and of two ranks that
share one card, has no ``reduce_scatter`` on CUDA tensors.  :data:`ONE`,
a group of one, does nothing, so the meshless and ``(n, 1)`` paths run as
without it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

__all__ = ["ModelGroup", "ONE", "model_group"]

_SIXTEEN_BIT = (torch.float16, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This rank's place on the `model` axis: ``size`` ranks, coordinate
    ``rank``, over ``group`` (a ``torch.distributed`` process group)."""

    size: int = 1
    rank: int = 0
    group: Any = None

    def local(self, n: int, what: str = "dim") -> int:
        """``n / size``; raises when ``size`` does not divide ``n``."""
        if n % self.size:
            raise ValueError(f"model={self.size} does not divide {what} {n}")
        return n // self.size

    def span(self, n_local: int) -> Tuple[int, int]:
        """``(offset, n_local)`` of this rank's block of a dim split in
        blocks of ``n_local``."""
        return self.rank * n_local, n_local

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group, in ``t``'s dtype (a fresh
        product: summed in place when it is not 16-bit)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        buf = t.float() if t.dtype in _SIXTEEN_BIT else t
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.dtype)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` joined along the last dim in coordinate
        order."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=-1)


ONE = ModelGroup()


def model_group(mesh) -> ModelGroup:
    """This rank's :class:`ModelGroup` on ``mesh`` (a ``DeviceMesh``);
    :data:`ONE` without a mesh or a `model` axis of one."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return ONE
    from repro_torch.launch.mesh import axis_sizes, mesh_coordinate

    size = axis_sizes(mesh)["model"]
    if size == 1:
        return ONE
    return ModelGroup(size, mesh_coordinate(mesh)["model"],
                      mesh.get_group("model"))
