"""Plain einsum oracles for the QuanTA kernels.

Written independently of the kernels and of their plain versions (one
einsum per stage), so a fault cannot hide in shared code.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["quanta_apply_ref", "quanta_linear_ref"]


def quanta_apply_ref(
    x: torch.Tensor,
    tensors: Sequence[torch.Tensor],
    dims_in: Tuple[int, ...],
    pairs: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """Apply the QuanTA chain via per-tensor einsum contractions."""
    batch = x.shape[:-1]
    h = x.reshape(*batch, *dims_in)
    nb = len(batch)
    for t, (m, n) in zip(tensors, pairs):
        n_ax = h.dim() - nb
        in_sub = [chr(ord("a") + i) for i in range(n_ax)]
        t_sub = ["Y", "Z", in_sub[m], in_sub[n]]
        out_sub = list(in_sub)
        out_sub[m], out_sub[n] = "Y", "Z"
        expr = (
            "..." + "".join(in_sub) + "," + "".join(t_sub)
            + "->..." + "".join(out_sub)
        )
        h = torch.einsum(expr, h, t)
    return h.reshape(*batch, -1)


def quanta_linear_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    tensors: Sequence[torch.Tensor],
    dims_in: Tuple[int, ...],
    pairs: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """Adapted linear: ``x @ w + chain(x)``."""
    return x @ w + quanta_apply_ref(x, tensors, dims_in, pairs).to(x.dtype)
