"""Plain oracles of the kernels: einsum for the QuanTA kernels, batched
products over the gathered rows for the banked-gather kernel.

The QuanTA oracles are written independently of the kernels and of their
plain versions (one einsum per stage), so a fault cannot hide in shared
code.  The banked-gather ones are the kernel's plain versions: its
wrappers take them for CPU tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["quanta_apply_ref", "quanta_linear_ref", "banked_lora_delta_ref",
           "banked_lora_linear_ref"]


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


def banked_lora_delta_ref(
    x: torch.Tensor,              # (B, S, d_in)
    a: torch.Tensor,              # (G+1, d_in, r) bank-stacked A
    b: torch.Tensor,              # (G+1, r, d_out) bank-stacked B
    ids: torch.Tensor,            # (B,) local bank rows, 0 = neutral
    scale: float,
) -> torch.Tensor:
    """Per slot ``s``: ``scale * ((x[s] @ A[ids[s]]) @ B[ids[s]])`` with x
    cast to the adapter dtype, both products in it, and the result cast
    back to x's dtype (``LoraAdapter.delta``'s rounding points)."""
    sa, sb = a.index_select(0, ids), b.index_select(0, ids)
    za = torch.bmm(x.to(a.dtype), sa)
    return (scale * torch.bmm(za, sb)).to(x.dtype)


def banked_lora_linear_ref(
    x: torch.Tensor,              # (B, S, d_in)
    w: torch.Tensor,              # (d_in, d_out), x's dtype
    a: torch.Tensor,
    b: torch.Tensor,
    ids: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """``x @ w`` rounded to x's dtype, plus :func:`banked_lora_delta_ref`
    (the sum rounded to x's dtype)."""
    return x @ w + banked_lora_delta_ref(x, a, b, ids, scale)
