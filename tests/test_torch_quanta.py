"""The port's QuanTA core and QuanTA kernels' plain versions, held against
the JAX package on the same numpy-seeded inputs (f32, CPU).  The JAX
kernels run as the JAX tests run them here: Pallas interpret mode."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quanta as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import quanta as TQ
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quanta_apply import quanta_apply
from repro_torch.kernels.quanta_linear import (
    quanta_linear, quanta_linear_plain,
)

# the modules (both packages re-export a function of the same name)
jfact = importlib.import_module("repro.core.factorize")
tfact = importlib.import_module("repro_torch.core.factorize")

TOL = dict(rtol=2e-5, atol=2e-5)      # f32, as tests/test_kernels.py


SHAPES = [
    # (d_in, d_out, dims_in)
    (64, 64, (4, 4, 4)),
    (24, 12, (4, 3, 2)),          # rectangular, d_in > d_out
    (128, 256, (8, 4, 4)),        # rectangular, d_in < d_out
    (256, 256, (4, 4, 4, 4)),     # N=4, six tensors
    (128, 128, (8, 4, 2, 2)),     # llama-style 4-axis scheme at small width
]


def _jax_adapter(d_in, d_out, dims, seed=0):
    return JQ.QuantaAdapter.create(
        jax.random.PRNGKey(seed), d_in, d_out, dims_in=dims, init="normal",
    )


def _x(shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("d,n_axes", [
    (4096, 3), (4096, 4), (896, 3), (64, 4), (11008, 4), (24, 3), (97, 1),
])
def test_factorize_matches(d, n_axes):
    assert tfact.factorize(d, n_axes) == jfact.factorize(d, n_axes)
    assert tfact.prime_factors(d) == jfact.prime_factors(d)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_pair_schedule_and_counts_match(n):
    assert tfact.pair_schedule(n) == jfact.pair_schedule(n)
    dims = tuple(range(2, 2 + n))
    pairs = tfact.pair_schedule(n)
    if pairs:
        assert tfact.param_count(dims, pairs) == jfact.param_count(dims, pairs)
        assert tfact.flops_per_token(dims, pairs) == \
            jfact.flops_per_token(dims, pairs)
    assert tfact.parse_scheme("16-8-8-4") == jfact.parse_scheme("16-8-8-4")


@pytest.mark.parametrize("d_in,d_out,dims", SHAPES)
def test_core_paths_match_jax(d_in, d_out, dims):
    """apply_sequential, materialize, fold_frozen_copy and merge."""
    ja = _jax_adapter(d_in, d_out, dims)
    ta = interop.quanta_from_numpy(ja, "cpu")
    assert ta.tensors[0].shape == tuple(ja.tensors[0].shape)
    assert ta.num_params == ja.num_params
    x = _x((3, 5, d_in))
    np.testing.assert_allclose(
        _np(TQ.apply_sequential(torch.from_numpy(x), ta.tensors, ta.dims_in,
                                ta.pairs, ta.dims_out)),
        np.asarray(JQ.apply_sequential(jnp.asarray(x), ja.tensors,
                                       ja.dims_in, ja.pairs, ja.dims_out)),
        **TOL)
    m_t = TQ.materialize(ta.tensors, ta.dims_in, ta.pairs, ta.dims_out)
    m_j = JQ.materialize(ja.tensors, ja.dims_in, ja.pairs, ja.dims_out)
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), **TOL)
    w0 = _x((d_in, d_out), seed=2)
    folded_t = TQ.fold_frozen_copy(torch.from_numpy(w0), ta)
    folded_j = JQ.fold_frozen_copy(jnp.asarray(w0), ja)
    np.testing.assert_allclose(_np(folded_t), np.asarray(folded_j), **TOL)
    np.testing.assert_allclose(
        _np(TQ.merge(folded_t, ta)), np.asarray(JQ.merge(folded_j, ja)),
        **TOL)
    # fold then merge restores the base (the adapter is unchanged)
    np.testing.assert_allclose(_np(TQ.merge(folded_t, ta)), w0, atol=1e-4)


@pytest.mark.parametrize("d_in,d_out,dims", SHAPES)
def test_apply_einsum_matches_jax(d_in, d_out, dims):
    """The App. G single-einsum path and its expression."""
    ja = _jax_adapter(d_in, d_out, dims)
    ta = interop.quanta_from_numpy(ja, "cpu")
    assert TQ.apply_einsum_expr(len(dims), ta.pairs) == \
        JQ.apply_einsum_expr(len(dims), ja.pairs)
    x = _x((2, 3, d_in), seed=4)
    got = _np(TQ.apply_einsum(torch.from_numpy(x), ta.tensors, ta.dims_in,
                              ta.pairs, ta.dims_out))
    np.testing.assert_allclose(
        got, np.asarray(JQ.apply_einsum(jnp.asarray(x), ja.tensors,
                                        ja.dims_in, ja.pairs, ja.dims_out)),
        **TOL)
    np.testing.assert_allclose(
        got, _np(TQ.apply_sequential(torch.from_numpy(x), ta.tensors,
                                     ta.dims_in, ta.pairs, ta.dims_out)),
        **TOL)


def _bf16_ulp(a):
    """One bf16 ulp of each element of ``a`` (8 significant bits)."""
    _, e = np.frexp(np.maximum(np.abs(a), 2.0 ** -126))
    return np.ldexp(1.0, e - 8)


def _in_dtype(ja, dtype):
    """The JAX adapter with its tensors in ``dtype`` (a numpy dtype)."""
    return JQ.QuantaAdapter(tuple(t.astype(dtype) for t in ja.tensors),
                            ja.dims_in, ja.dims_out, ja.pairs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out,dims", SHAPES)
def test_plain_chain_matches_jax_kernel(d_in, d_out, dims, dtype):
    """The plain version of quanta_apply against the JAX kernel (interpret
    mode) and both einsum oracles.  In bf16 both round every stage to
    x's dtype after an fp32 sum, so they agree bit for bit."""
    ja = _in_dtype(_jax_adapter(d_in, d_out, dims), jnp.dtype(dtype))
    ta = interop.quanta_from_numpy(ja, "cpu")
    x = _x((5, 9, d_in))
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jops.quanta_apply_fused(xj, ja, block_rows=16)
                      ).astype(np.float32)
    got = _np(tops.quanta_apply_fused(xt, ta).float())
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, **TOL)
    ref_j = np.asarray(jref.quanta_apply_ref(xj, ja.tensors, ja.dims_in,
                                             ja.pairs))
    ref_t = _np(tref.quanta_apply_ref(xt, ta.tensors, ta.dims_in, ta.pairs))
    np.testing.assert_allclose(ref_t, ref_j, **TOL)
    np.testing.assert_allclose(got, ref_t, **TOL)


# the FULL configs' q_proj and v_proj chains: yi-6b's 16-16-16 (v_proj
# 4096 -> 512), phi3-medium-14b's 16-8-8-5 (v_proj 5120 -> 1280) and
# minicpm-2b's 16-12-12
FULL_CHAINS = [
    (4096, 4096, (16, 16, 16)), (4096, 512, (64, 8, 8)),
    (5120, 5120, (16, 8, 8, 5)), (5120, 1280, (32, 8, 5, 4)),
    (2304, 2304, (16, 12, 12)),
]


@pytest.mark.parametrize("d_in,d_out,dims", FULL_CHAINS,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_plain_chain_matches_jax_kernel_at_full_schemes(d_in, d_out, dims):
    """The plain chain (``apply_sequential``) against the JAX kernel in
    interpret mode at the FULL configs' schemes, 8 rows in f32, with the
    dims ``choose_dims`` gives each projection."""
    from repro_torch.core.peft import choose_dims

    assert choose_dims(d_in, d_out, len(dims), None if d_in != d_out
                       else "-".join(map(str, dims)))[0] == dims
    ja = _jax_adapter(d_in, d_out, dims)
    ta = interop.quanta_from_numpy(ja, "cpu")
    assert ta.d_out == d_out
    x = _x((8, d_in))
    want = np.asarray(jops.quanta_apply_fused(jnp.asarray(x), ja,
                                              block_rows=8))
    got = _np(TQ.apply_sequential(torch.from_numpy(x), ta.tensors,
                                  ta.dims_in, ta.pairs))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out,dims", SHAPES[:3] + SHAPES[4:])
def test_plain_linear_matches_jax_kernel(d_in, d_out, dims, dtype):
    """``x @ w + chain(x)``: in bf16 every element within one ulp of the
    JAX kernel's (the fp32 sums of ``x @ w`` run in another order)."""
    ja = _in_dtype(_jax_adapter(d_in, d_out, dims), jnp.dtype(dtype))
    ta = interop.quanta_from_numpy(ja, "cpu")
    x = _x((3, 8, d_in))
    w = 0.05 * _x((d_in, d_out), seed=2)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tdt = getattr(torch, dtype)
    want = np.asarray(jops.quanta_linear_fused(
        xj, wj, ja, block_rows=8, block_cols=min(d_out, 64))
    ).astype(np.float32)
    got = _np(tops.quanta_linear_fused(torch.from_numpy(x).to(tdt),
                                       torch.from_numpy(w).to(tdt), ta
                                       ).float())
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
        return
    np.testing.assert_allclose(got, want, **TOL)
    ref_j = np.asarray(jref.quanta_linear_ref(
        xj, wj, ja.tensors, ja.dims_in, ja.pairs))
    np.testing.assert_allclose(got, ref_j, **TOL)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("d_in,d_out,dims", [SHAPES[0], SHAPES[2], SHAPES[4]])
def test_adapter_apply_matches_jax(d_in, d_out, dims, backend):
    """QuantaAdapter.apply (the pallas backend through quanta_linear),
    delta and matrix."""
    ja = _jax_adapter(d_in, d_out, dims)
    ta = interop.quanta_from_numpy(ja, "cpu")
    x = _x((4, d_in))
    w = 0.05 * _x((d_in, d_out), seed=3)
    want = np.asarray(ja.apply(jnp.asarray(x), jnp.asarray(w), backend))
    got = _np(ta.apply(torch.from_numpy(x), torch.from_numpy(w), backend))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(_np(ta.delta(torch.from_numpy(x))),
                               np.asarray(ja.delta(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(_np(ta.matrix()), np.asarray(ja.matrix()),
                               **TOL)


def test_fold_free_adapters_are_refused():
    """Fold-free QuanTA (S kept as factors) crosses over with its S, and is
    refused as a folded adapter: its delta subtracts S's chain, and as a
    bank tenant it stays bare (no ``RebasedAdapter``, no dense base),
    as the JAX package's ``tenant_path_adapters`` keeps it."""
    from repro_torch.core.bank import tenant_path_adapters
    from repro_torch.core.peft import AdapterLeafSpec, AdapterSet

    ja = _jax_adapter(64, 64, (4, 4, 4))
    ff = JQ.QuantaAdapter(ja.tensors, ja.dims_in, ja.dims_out, ja.pairs,
                          frozen=ja.tensors)
    ta = interop.quanta_from_numpy(ff, "cpu")
    assert ta.fold_free and len(ta.frozen) == len(ta.tensors)
    x = _x((5, 64))
    assert np.abs(_np(ta.delta(torch.from_numpy(x)))).max() == 0.0
    aset = AdapterSet({"p": ta}, (AdapterLeafSpec("p", "quanta", False, 64,
                                                  64, fold=False),))
    adapter, spec = tenant_path_adapters("ff", aset)["p"]
    assert adapter is ta and spec.fold is False and adapter.delta_form
    from repro.core.bank import tenant_path_adapters as j_tenant
    from repro.core.peft import AdapterLeafSpec as JSpec, AdapterSet as JSet

    j_adapter, _ = j_tenant("ff", JSet({"p": ff}, (JSpec(
        "p", "quanta", False, 64, 64, fold=False),)))["p"]
    assert j_adapter is ff
    gen = torch.Generator().manual_seed(0)
    ad = TQ.QuantaAdapter.create(gen, 64, 64, n_axes=3)
    assert ad.num_params == tfact.param_count(ad.dims_in, ad.pairs)


@pytest.mark.parametrize("fold_free", [False, True])
def test_banked_delta_matches_jax(fold_free):
    """A bank-stacked QuanTA group (3 rows), folded or fold-free: its
    per-slot delta under the kernel backend (the chain wrapper slot by
    slot, its plain version on the CPU) and the reference gather both
    equal the JAX bank's ``vmap`` of ``delta`` over gathered rows."""
    rows = [_jax_adapter(64, 64, (4, 4, 4), seed=s) for s in range(3)]
    frozen = None
    if fold_free:
        frozen = tuple(jnp.stack(ts) for ts in zip(*(
            _jax_adapter(64, 64, (4, 4, 4), seed=10 + s).tensors
            for s in range(3))))
    ja = JQ.QuantaAdapter(
        tuple(jnp.stack(ts) for ts in zip(*(a.tensors for a in rows))),
        rows[0].dims_in, rows[0].dims_out, rows[0].pairs, frozen=frozen)
    ta = interop.quanta_from_numpy(ja, "cpu")
    ids = np.array([2, 0, 1, 2], dtype=np.int32)
    x = _x((4, 5, 64))
    want = np.asarray(ja.banked_delta(jnp.asarray(x), jnp.asarray(ids)))
    assert np.abs(want).max() > 0
    before = quanta_apply.launches
    for backend in ("pallas", "reference"):
        got = ta.banked_delta(torch.from_numpy(x),
                              torch.from_numpy(ids).long(), backend)
        np.testing.assert_allclose(_np(got), want, **TOL)
    assert quanta_apply.launches == before


def test_kernel_wrappers_route_cpu_to_plain():
    """On CPU tensors the wrappers equal their plain versions exactly and
    launch nothing."""
    ja = _jax_adapter(128, 128, (8, 4, 2, 2))
    ta = interop.quanta_from_numpy(ja, "cpu")
    x = torch.from_numpy(_x((7, 128)))
    w = torch.from_numpy(0.05 * _x((128, 128), seed=2))
    before = (quanta_apply.launches, quanta_linear.launches)
    assert torch.equal(quanta_apply(x, ta.tensors, ta.dims_in, ta.pairs),
                       TQ.apply_sequential(x, ta.tensors, ta.dims_in, ta.pairs))
    assert torch.equal(
        quanta_linear(x, w, ta.tensors, ta.dims_in, ta.pairs),
        quanta_linear_plain(x, w, ta.tensors, ta.dims_in, ta.pairs))
    assert (quanta_apply.launches, quanta_linear.launches) == before


@pytest.mark.parametrize("dtype,limit,rows", [
    (torch.bfloat16, 232_448, 8),      # an H100's per-block opt-in limit
    (torch.float32, 232_448, 4),
    (torch.bfloat16, 101_376, 2),      # a card with 99 KB per block
])
def test_chain_row_tile_fits_a_block(dtype, limit, rows):
    """The chain kernel's row tile at llama2-7b's 16-8-8-4 scheme fits the
    device's limit, and twice the tile would not.  float32 (the first
    SIMT body): two row buffers plus the staged fp32 tensor and offset
    tables.  bf16 (the register-tiled body, ``smem.chain_plan``): two row
    buffers, the column tables and every stage tensor in bf16, or, on the
    99 KB card, the largest one streamed a stage at a time; only a block
    without room for one row's buffers raises (at 48 KB the tensors
    stream in chunks of their rows)."""
    from repro_torch.kernels import smem

    dims, pairs = (16, 8, 8, 4), tfact.pair_schedule(4)
    shapes = TQ.tensor_shapes(dims, pairs)
    if dtype == torch.bfloat16:
        plan = smem.chain_plan(dims, shapes, pairs, limit)
        assert plan.rows == rows and plan.resident == (limit > 200_000)
        assert plan.smem <= limit < smem.chain_bf16_smem_bytes(
            2 * rows, plan.layout, plan.resident)
        with pytest.raises(ValueError):
            smem.chain_plan(dims, shapes, pairs, 16 * 1024)
        return
    words = smem.chain_stage_words(dims, shapes, pairs)
    assert words == 128 * 129 + 2 * 128
    size = torch.tensor([], dtype=dtype).element_size()
    assert smem.chain_rows_per_block(4096, words, size, limit) == rows
    assert smem.chain_smem_bytes(rows, 4096, words, size) <= limit \
        < smem.chain_smem_bytes(2 * rows, 4096, words, size)
    with pytest.raises(ValueError):
        smem.chain_rows_per_block(4096, words, size, 64 * 1024)
