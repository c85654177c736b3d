"""The port's rank tools (``repro_torch.core.analysis``) against the JAX
package's on matrices with a spread spectrum (``U diag(s) V^T``, s
distinct, some singular values far under the rank tolerance):
``operator_rank`` and ``rank_bounds`` exactly, ``effective_rank``,
``similarity_grid`` and ``subspace_similarity`` within 1e-5; each
computes in its input's dtype.  Then the JAX package's theory properties
(``tests/test_theory.py``) on the port: full-rank tensors give a
full-rank operator (Thm. 6.2's special case) where equal-budget LoRA is
not, rank-deficient tensors give an operator within Thm. 6.2's bounds
(three seeds, float64), the subspace similarity of an update with itself,
and the App. A contrast of low- and high-rank updates."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import analysis as janalysis
from repro_torch.core import (
    effective_rank, materialize, operator_rank, pair_schedule, rank_bounds,
    similarity_grid, subspace_similarity,
)


def _spread(n, m, rank, seed, dtype=np.float32):
    """``U diag(s) V^T`` (n x m): ``rank`` distinct singular values from 1
    down to 1e-3, the rest 1e-9 of the top (far under any tolerance)."""
    rs = np.random.RandomState(seed)
    u, _ = np.linalg.qr(rs.standard_normal((n, n)))
    v, _ = np.linalg.qr(rs.standard_normal((m, m)))
    k = min(n, m)
    s = np.full(k, 1e-9)
    s[:rank] = np.logspace(0, -3, rank)
    return ((u[:, :k] * s) @ v[:, :k].T).astype(dtype)


CASES = [(32, 32, 20, 0), (48, 32, 32, 1), (24, 40, 7, 2)]


@pytest.mark.parametrize("n,m,rank,seed", CASES)
def test_ranks_match_jax(n, m, rank, seed):
    """``operator_rank`` equal to the JAX package's (and to the planted
    rank) at two tolerances, ``effective_rank`` within 1e-5."""
    a = _spread(n, m, rank, seed)
    t, j = torch.from_numpy(a), jnp.asarray(a)
    for rtol in (1e-5, 3e-2):
        assert operator_rank(t, rtol) == janalysis.operator_rank(j, rtol)
    assert operator_rank(t) == rank
    np.testing.assert_allclose(effective_rank(t),
                               janalysis.effective_rank(j), rtol=1e-5)


@pytest.mark.parametrize("n,m,rank,seed", CASES)
def test_similarity_matches_jax(n, m, rank, seed):
    """The (i, j) grid between two updates and the overlap of two V
    matrices, within 1e-5 of the JAX package's."""
    a, b = _spread(n, m, rank, seed), _spread(n, m, rank, seed + 10)
    k = min(8, rank)
    got = similarity_grid(torch.from_numpy(a), torch.from_numpy(b), k, k)
    want = janalysis.similarity_grid(jnp.asarray(a), jnp.asarray(b), k, k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (k, k)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    v1 = np.linalg.svd(a)[2].T.astype(np.float32)
    v2 = np.linalg.svd(b)[2].T.astype(np.float32)
    for i, jj in ((1, 1), (3, 5), (k, k)):
        np.testing.assert_allclose(
            subspace_similarity(torch.from_numpy(v1), torch.from_numpy(v2),
                                i, jj),
            janalysis.subspace_similarity(jnp.asarray(v1), jnp.asarray(v2),
                                          i, jj), atol=1e-5)


def test_rank_bounds_match_jax():
    """Thm. 6.2's bounds: integers equal to the JAX package's, the lower
    one clipped at 0."""
    cases = [((12, 8, 6), (12, 8, 6), 24), ((3, 8, 6), (12, 8, 6), 24),
             ((1, 1, 1), (12, 8, 6), 24), ((256, 200, 128), (256, 256, 128),
                                           2048)]
    for ranks, dims, d in cases:
        assert rank_bounds(ranks, dims, d) == janalysis.rank_bounds(
            ranks, dims, d)
    assert rank_bounds((12, 8, 6), (12, 8, 6), 24) == (24, 24)
    assert rank_bounds((1, 1, 1), (12, 8, 6), 24)[0] == 0


def test_dtype_follows_the_input():
    """float64 in, float64 arithmetic: a singular value 1e-9 of the top
    counts at rtol 1e-10 only there (float32 noise is about 1e-7)."""
    a = _spread(32, 32, 20, 0, np.float64)
    t = torch.from_numpy(a)
    assert operator_rank(t, rtol=1e-10) == 32
    assert operator_rank(t.float(), rtol=1e-5) == 20
    assert similarity_grid(t, t, 4, 4).dtype == torch.float64


def _tensors(dims, pairs, seed, make):
    """The chain's tensors, float64, each ``make(rs, dm * dn)`` reshaped
    to ``(dm, dn, dm, dn)`` (square chain: dims stay put)."""
    rs = np.random.RandomState(seed)
    out = []
    for m, n in pairs:
        dd = dims[m] * dims[n]
        out.append(torch.from_numpy(make(rs, dd)).reshape(
            dims[m], dims[n], dims[m], dims[n]))
    return out


def test_full_rank_tensors_give_full_rank_operator():
    """Thm. 6.2's special case: well-conditioned full-rank tensors
    (identity plus noise) give a full-rank operator, where LoRA of the same
    parameter count has rank r << d."""
    dims, pairs = (4, 3, 2), pair_schedule(3)
    ts = _tensors(dims, pairs, 0, lambda rs, dd: np.eye(dd)
                  + 0.1 * rs.standard_normal((dd, dd)))
    assert operator_rank(materialize(ts, dims, pairs)) == 24
    r_equiv = sum(t.numel() for t in ts) // (2 * 24)
    assert r_equiv < 24


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_representation_bounds(seed):
    """Thm. 6.2 Eq. 10 on random rank-deficient tensors: lower <= rank of
    the operator (float64, rtol 1e-6) <= upper."""
    dims, pairs = (4, 3, 2), pair_schedule(3)
    ranks = []

    def make(rs, dd):
        r = rs.randint(1, dd + 1)
        ranks.append((r, dd))
        return rs.standard_normal((dd, r)) @ rs.standard_normal((r, dd))

    full = materialize(_tensors(dims, pairs, seed, make), dims, pairs)
    lo, hi = rank_bounds([r for r, _ in ranks], [dd for _, dd in ranks], 24)
    assert lo <= operator_rank(full, rtol=1e-6) <= hi, (lo, hi, ranks)


def test_subspace_similarity_props():
    """An update against itself: phi(i, i) = 1 on the grid's diagonal and
    for its own V; two independent updates stay within [0, 1]."""
    rs = np.random.RandomState(0)
    w = torch.from_numpy(rs.standard_normal((32, 32)).astype(np.float32))
    grid = similarity_grid(w, w, 8, 8)
    np.testing.assert_allclose(torch.diagonal(grid).numpy(), 1.0, atol=1e-5)
    w2 = torch.from_numpy(rs.standard_normal((32, 32)).astype(np.float32))
    grid2 = similarity_grid(w, w2, 8, 8)
    assert bool(((grid2 >= -1e-6) & (grid2 <= 1 + 1e-6)).all())
    v = torch.linalg.svd(w).Vh.T
    assert abs(subspace_similarity(v, v, 4, 4) - 1.0) < 1e-5


def test_low_vs_high_rank_update_similarity_contrast():
    """App. A's diagnostic tells a shared low-rank update from high-rank
    ones (the RTE-vs-DROP contrast of Fig. 2)."""
    rs = np.random.RandomState(0)
    d = 48

    def g(*shape):
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32))

    low1 = g(d, 4) @ g(4, d)
    high1, high2 = g(d, d), g(d, d)
    g_low = similarity_grid(low1 + 0.05 * high1, low1 + 0.05 * high2, 16, 16)
    g_high = similarity_grid(high1, high1 + 0.2 * high2, 16, 16)
    assert g_low[3, 3] > 0.8
    assert g_low[15, 15] < g_high[15, 15]
    assert g_high[15, 15] > 0.8
