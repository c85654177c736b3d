"""Rank / subspace analysis utilities (port of ``repro/core/analysis.py``;
paper §3, §6, App. A).

* :func:`subspace_similarity` -- the Grassmann-style overlap
  ``phi(i, j) = ||V1[:, :i]^T V2[:, :j]||_F^2 / min(i, j)`` used to measure
  the "intrinsic rank" of fine-tuning updates (App. A, Eq. A.1).
* :func:`similarity_grid` -- the full (i, j) grid behind Fig. 2 / A.1 / A.2.
* :func:`operator_rank` -- numerical rank of a materialized operator.
* :func:`effective_rank` -- entropy-based effective rank.
* :func:`rank_bounds` -- the two sides of the rank representation theorem
  (Thm. 6.2, Eq. 10).

Every function computes in its input's dtype on its input's device
(``torch.linalg.svd``): at the widths of a full model the float32
rounding noise of a materialized chain, about ``d * eps * sigma_max``,
sits above a 1e-5 relative rank tolerance, so a rank there is taken in
float64.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = [
    "subspace_similarity",
    "similarity_grid",
    "operator_rank",
    "rank_bounds",
    "effective_rank",
]


def subspace_similarity(v1: torch.Tensor, v2: torch.Tensor, i: int,
                        j: int) -> float:
    """App. A Eq. (A.1): overlap of the first ``i`` and ``j`` right singular
    vectors.  ``v1``/``v2`` are the (column-orthonormal) V matrices of the
    two weight updates."""
    return float(torch.linalg.matrix_norm(v1[:, :i].T @ v2[:, :j]) ** 2
                 / min(i, j))


def similarity_grid(dw1: torch.Tensor, dw2: torch.Tensor, max_i: int,
                    max_j: int) -> torch.Tensor:
    """Full subspace-similarity grid between two weight updates (Fig. 2),
    ``(max_i, max_j)`` in the inputs' dtype.

    Entry ``[i-1, j-1]`` is ``phi(i, j)``; computed in O(max_i*max_j) from a
    single cross-Gram matrix instead of repeated norms.
    """
    v1 = torch.linalg.svd(dw1, full_matrices=False).Vh[:max_i].T
    v2 = torch.linalg.svd(dw2, full_matrices=False).Vh[:max_j].T
    sq = (v1.T @ v2) ** 2                      # (max_i, max_j) cross-Gram
    # phi(i, j) = sum_{<=i, <=j} g^2 / min(i, j): 2-D prefix sums.
    csum = sq.cumsum(0).cumsum(1)
    i_idx = torch.arange(1, max_i + 1, device=sq.device)[:, None]
    j_idx = torch.arange(1, max_j + 1, device=sq.device)[None, :]
    return csum / torch.minimum(i_idx, j_idx).to(sq.dtype)


def operator_rank(mat: torch.Tensor, rtol: float = 1e-5) -> int:
    """Numerical rank via SVD with relative tolerance."""
    s = torch.linalg.svdvals(mat)
    return int((s > rtol * s[0]).sum())


def effective_rank(mat: torch.Tensor) -> float:
    """Entropy-based effective rank (Roy & Vetterli): exp(H(sigma/sum))."""
    s = torch.linalg.svdvals(mat)
    p = s / s.sum().clamp_min(1e-30)
    h = -torch.where(p > 0, p * torch.log(p.clamp_min(1e-30)),
                     torch.zeros_like(p)).sum()
    return float(torch.exp(h))


def rank_bounds(
    tensor_ranks: Sequence[int],
    tensor_dims: Sequence[int],
    d: int,
) -> Tuple[int, int]:
    """Thm. 6.2 Eq. (10):  lower/upper bound on the full operator rank.

    ``tensor_ranks[a]`` = rank of tensor a (as a (dm*dn, dm*dn) matrix),
    ``tensor_dims[a]`` = dm*dn, ``d`` = total dimension.
    """
    n_t = len(tensor_ranks)
    per_tensor = [d * r // dd for r, dd in zip(tensor_ranks, tensor_dims)]
    lower = sum(per_tensor) - d * (n_t - 1)
    upper = min(per_tensor)
    return max(lower, 0), upper
