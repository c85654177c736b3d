"""Hidden-dimension factorization utilities for QuanTA.

QuanTA views a hidden vector ``x \\in R^d`` as an N-axis tensor
``x \\in R^{d_1 x d_2 x ... x d_N}`` with ``d = d_1 * d_2 * ... * d_N``
(paper §5, "Construction").  This module picks / validates such
factorizations and generates the two-axis tensor schedule of App. G.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

__all__ = [
    "prime_factors",
    "factorize",
    "parse_scheme",
    "pair_schedule",
    "param_count",
    "flops_per_token",
]


def prime_factors(d: int) -> list[int]:
    """Prime factorization of ``d`` in ascending order."""
    if d < 1:
        raise ValueError(f"d must be positive, got {d}")
    out = []
    n = d
    f = 2
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 1
    if n > 1:
        out.append(n)
    return out


def factorize(d: int, n_axes: int) -> Tuple[int, ...]:
    """Factor ``d`` into ``n_axes`` balanced factors, largest first.

    Greedy: distribute prime factors onto the currently-smallest axis so the
    factors end up near ``d**(1/n_axes)``.  Matches the paper's schemes for
    the common LLM widths, e.g. ``factorize(4096, 3) == (16, 16, 16)``.
    """
    if n_axes < 1:
        raise ValueError(f"n_axes must be >= 1, got {n_axes}")
    primes = prime_factors(d)
    if len(primes) < n_axes:
        raise ValueError(
            f"d={d} has only {len(primes)} prime factors; cannot split into "
            f"{n_axes} axes > 1"
        )
    dims = [1] * n_axes
    # Largest primes first, always placed on the smallest running axis.
    for p in sorted(primes, reverse=True):
        dims[dims.index(min(dims))] *= p
    return tuple(sorted(dims, reverse=True))


def parse_scheme(scheme: str) -> Tuple[int, ...]:
    """Parse a paper-style scheme string like ``"16-8-8-4"`` into dims."""
    dims = tuple(int(s) for s in scheme.split("-"))
    if any(x < 1 for x in dims):
        raise ValueError(f"bad scheme {scheme!r}")
    return dims


def pair_schedule(n_axes: int) -> Tuple[Tuple[int, int], ...]:
    """The paper's canonical tensor schedule: one tensor per axis pair.

    Ported from App. G: ``itertools.combinations(range(-1, -N-1, -1), 2)``
    with negative axes converted to positive ``(m, n)``, ``m < n``.  List
    order == sequential application order (first entry applied first).

    >>> pair_schedule(3)
    ((1, 2), (0, 2), (0, 1))
    """
    pairs = []
    for (dim1, dim2) in itertools.combinations(range(-1, -n_axes - 1, -1), 2):
        m, n = dim2 + n_axes, dim1 + n_axes  # dim2 is more negative -> earlier
        pairs.append((m, n))
    return tuple(pairs)


def param_count(
    dims_in: Sequence[int],
    pairs: Sequence[Tuple[int, int]],
    dims_out: Sequence[int] | None = None,
) -> int:
    """Trainable parameters of a QuanTA layer: ``sum_a (dm*dn)_out*(dm*dn)_in``.

    Paper §6 ("Memory and computational complexity"): each square tensor has
    ``(dm*dn)**2`` elements.  Rectangular tensors (App. B) count
    ``out_m*out_n*in_m*in_n``.
    """
    dims_out = tuple(dims_out) if dims_out is not None else tuple(dims_in)
    cur = list(dims_in)
    total = 0
    for (m, n) in pairs:
        om = dims_out[m] if m == 0 else cur[m]
        on = dims_out[n] if n == 0 else cur[n]
        total += om * on * cur[m] * cur[n]
        cur[m], cur[n] = om, on
    return total


def flops_per_token(
    dims_in: Sequence[int],
    pairs: Sequence[Tuple[int, int]],
    dims_out: Sequence[int] | None = None,
) -> int:
    """Forward MACs per token for the sequential chain: ``d * sum_a dm*dn``.

    Paper §6: each two-axis contraction is a batched matmul costing
    ``d * dm * dn`` multiply-accumulates over the full hidden vector.
    """
    dims_out = tuple(dims_out) if dims_out is not None else tuple(dims_in)
    cur = list(dims_in)
    total = 0
    for (m, n) in pairs:
        om = dims_out[m] if m == 0 else cur[m]
        on = dims_out[n] if n == 0 else cur[n]
        batch = math.prod(cur) // (cur[m] * cur[n])
        total += batch * om * on * cur[m] * cur[n]
        cur[m], cur[n] = om, on
    return total
