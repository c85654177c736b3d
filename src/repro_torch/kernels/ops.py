"""Public wrappers around the QuanTA kernels.

They flatten leading dims to rows, cast the stage tensors (and the
weight) to x's dtype as the JAX wrappers do, and hand the 2-D problem to
``quanta_apply`` / ``quanta_linear``, which check device, dtype and
contiguity and send CUDA tensors to the kernels and CPU tensors to the
plain versions.  Unlike the JAX ``kernels/ops.py`` there is no row padding
(the kernels mask the ragged tile) and no VMEM gate (the two-phase
``quanta_linear`` has no full-width scratch).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.quanta_apply import quanta_apply
from repro_torch.kernels.quanta_linear import quanta_linear

__all__ = ["quanta_apply_fused", "quanta_linear_fused"]


def _rows(x: torch.Tensor):
    batch = x.shape[:-1]
    return x.reshape(math.prod(batch), x.shape[-1]), batch


def quanta_apply_fused(x: torch.Tensor, adapter) -> torch.Tensor:
    """Fused chain application of a QuanTA adapter: a drop-in for
    ``adapter.delta``."""
    xf, batch = _rows(x)
    tensors = [t.to(x.dtype) for t in adapter.tensors]
    out = quanta_apply(xf, tensors, adapter.dims_in, adapter.pairs)
    return out.reshape(*batch, adapter.d_out)


def quanta_linear_fused(x: torch.Tensor, w: torch.Tensor, adapter,
                        col: int = 0) -> torch.Tensor:
    """Adapted linear ``x @ w + chain(x)`` through the two-phase kernel;
    for a column shard ``w`` the chain's columns from ``col`` on."""
    xf, batch = _rows(x)
    tensors = [t.to(x.dtype) for t in adapter.tensors]
    out = quanta_linear(xf, w.to(x.dtype), tensors, adapter.dims_in,
                        adapter.pairs, col)
    return out.reshape(*batch, w.shape[1])
