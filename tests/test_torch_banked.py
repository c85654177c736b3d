"""The banked-gather kernel's plain versions (``kernels/ref.py``, what the
wrappers of ``kernels/banked_gather.py`` run for CPU tensors) held against
the JAX Pallas kernel ``repro.kernels.banked_gather`` in interpret mode:
float32, seq 1 and 7, remainder column blocks, 2-D x, the neutral row's
exact zero, bad shapes refused; the tile plan that replaces the TPU's VMEM
gate; and the protocol hooks routing bank-stacked LoRA to the wrappers.

Tolerance: float32 at rtol/atol 1e-5.  Both sides compute the same two
factored products per slot in float32, in another order of summation, on
outputs of magnitude up to about 30 (readings up to 2e-6 relative)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.baselines import LoraAdapter as JLora
from repro_torch.core.baselines import LoraAdapter
from repro_torch.kernels import banked_gather as BG
from repro_torch.kernels import launch_counts
from repro_torch.kernels.smem import (
    BANKED_TILES, banked_gather_plan,
)

# the JAX module (its package may re-export functions of the same names)
j_bg = importlib.import_module("repro.kernels.banked_gather")

TOL = dict(rtol=1e-5, atol=1e-5)


def _bank(seed, n_rows, d_in, d_out, rank):
    """Bank-stacked A, B with row 0 neutral (exact zeros), as numpy."""
    rs = np.random.RandomState(seed)
    a = rs.standard_normal((n_rows, d_in, rank)).astype(np.float32)
    b = rs.standard_normal((n_rows, rank, d_out)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    return a, b


def _x(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seq", [1, 7])
@pytest.mark.parametrize("block_cols", [512, 24])     # 24: remainder blocks
def test_delta_plain_matches_jax_kernel(seq, block_cols):
    a, b = _bank(0, 5, 48, 72, 4)
    x = _x(1, 4, seq, 48)
    ids = np.asarray([2, 0, 4, 2], np.int32)
    want = j_bg.banked_lora_delta(jnp.asarray(x), jnp.asarray(a),
                                  jnp.asarray(b), jnp.asarray(ids),
                                  scale=0.5, block_cols=block_cols,
                                  interpret=True)
    tx, ta, tb, tids = _t(x, a, b, ids)
    got = BG.banked_lora_delta(tx, ta, tb, tids, scale=0.5)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("block_cols", [512, 48])
def test_fused_linear_plain_matches_jax_kernel(block_cols):
    a, b = _bank(2, 4, 32, 80, 2)
    w = _x(3, 32, 80)
    x = _x(4, 3, 5, 32)
    ids = np.asarray([1, 3, 0], np.int32)
    want = j_bg.banked_lora_linear(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(ids), scale=2.0,
                                   block_cols=block_cols, interpret=True)
    tx, tw, ta, tb, tids = _t(x, w, a, b, ids)
    got = BG.banked_lora_linear(tx, tw, ta, tb, tids, scale=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_two_dim_x_matches_jax_kernel(fused):
    a, b = _bank(8, 4, 24, 56, 2)
    x = _x(9, 3, 24)
    w = _x(10, 24, 56)
    for perm in ([1, 2, 3], [3, 0, 1]):
        ids = np.asarray(perm, np.int32)
        tx, tw, ta, tb, tids = _t(x, w, a, b, ids)
        if fused:
            want = j_bg.banked_lora_linear(
                jnp.asarray(x), jnp.asarray(w), jnp.asarray(a),
                jnp.asarray(b), jnp.asarray(ids), scale=0.25,
                interpret=True)
            got = BG.banked_lora_linear(tx, tw, ta, tb, tids, scale=0.25)
        else:
            want = j_bg.banked_lora_delta(
                jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                jnp.asarray(ids), scale=0.25, interpret=True)
            got = BG.banked_lora_delta(tx, ta, tb, tids, scale=0.25)
        assert tuple(got.shape) == (3, 56) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_neutral_row_adds_exact_zero():
    a, b = _bank(5, 3, 16, 40, 4)
    x = _x(6, 2, 1, 16)
    w = _x(7, 16, 40)
    tx, tw, ta, tb = _t(x, w, a, b)
    ids = torch.zeros((2,), dtype=torch.int32)
    assert not BG.banked_lora_delta(tx, ta, tb, ids, scale=1.5).any()
    y = BG.banked_lora_linear(tx, tw, ta, tb, ids, scale=1.5)
    assert torch.equal(y, tx @ tw)


def test_adapter_dtype_rounding_points():
    """bf16 activations meet f32 factors: x is cast to the factors' dtype,
    the delta back to bf16, and the base is rounded to bf16 on its own
    before the add (``LoraAdapter.delta`` and the TPU kernel body)."""
    a, b = _bank(11, 3, 32, 48, 4)
    x = torch.from_numpy(_x(12, 3, 2, 32)).to(torch.bfloat16)
    w = torch.from_numpy(_x(13, 32, 48)).to(torch.bfloat16)
    ta, tb = _t(a, b)
    ids = torch.tensor([1, 2, 0], dtype=torch.int32)
    got = BG.banked_lora_linear(x, w, ta, tb, ids, scale=2.0)
    assert got.dtype == torch.bfloat16
    delta = torch.stack([
        LoraAdapter(ta[i], tb[i], 2.0 * 4).delta(x[s])
        for s, i in enumerate(ids.tolist())])
    assert torch.equal(got, x @ w + delta)


def test_bad_shapes_raise():
    a, b = _bank(13, 3, 8, 8, 2)
    ta, tb = _t(a, b)
    ids = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="expects"):
        BG.banked_lora_delta(torch.zeros(8), ta, tb, ids, scale=1.0)
    with pytest.raises(ValueError, match="expects"):
        BG.banked_lora_delta(torch.zeros(1, 1, 1, 8), ta, tb, ids,
                             scale=1.0)
    with pytest.raises(ValueError, match="does not fit"):
        BG.banked_lora_delta(torch.zeros(1, 7), ta, tb, ids, scale=1.0)
    with pytest.raises(ValueError, match="ids"):
        BG.banked_lora_delta(torch.zeros(2, 8), ta, tb, ids, scale=1.0)
    with pytest.raises(ValueError, match="incompatible"):
        BG.banked_lora_linear(torch.zeros(1, 8), torch.zeros(8, 9), ta, tb,
                              ids, scale=1.0)
    with pytest.raises(ValueError, match="rank"):
        banked_gather_plan(8, 1, 4096, 4096, 65, True, 132)


def test_tile_plan_runs_every_shape():
    """No VMEM gate: the TPU's full-K tile overflows at prefill (8 slots
    of 384 rows of 4096) and the JAX caller falls back; the CUDA plan
    tiles K and takes it.  At decode the wgmma decode body's 64-column
    blocks split K until the SMs hold four each, and the shrink splits K
    until every SM has two blocks."""
    assert not j_bg.banked_vmem_ok(384, 4096, 4096, 16, 512,
                                   fuse_base=True)
    prefill = banked_gather_plan(8, 384, 4096, 4096, 16, True, 132)
    assert prefill == (0, 384, 2, 2048, 1)
    decode = banked_gather_plan(8, 1, 4096, 4096, 16, True, 132)
    assert decode == (1, 64, 32, 128, 8)
    # at most 64 rows take the decode body at any width; its K split
    # never leaves a part empty
    assert banked_gather_plan(8, 1, 4096, 11008, 16, True, 132)[:2] == (
        1, 172)
    assert banked_gather_plan(8, 1, 4096, 11008, 16, True, 132).gsplits == 3
    assert banked_gather_plan(4, 16, 4096, 4096, 16, True, 132).variant == 1
    assert banked_gather_plan(5, 13, 4096, 4096, 16, True, 132).variant == 0
    assert banked_gather_plan(8, 1, 4096, 4096, 16, False, 132).variant == 2
    # small K: one split of the whole of it
    assert banked_gather_plan(3, 37, 64, 200, 8, True, 132)[2:4] == (1, 64)
    for n, seq, d_in in ((8, 1, 4096), (8, 384, 4096), (2, 5, 200)):
        plan = banked_gather_plan(n, seq, d_in, 64, 4, True, 132)
        assert plan.k_split % 64 == 0
        assert (plan.splits - 1) * plan.k_split < d_in <= (
            plan.splits * plan.k_split)
        steps = -(-d_in // 64)
        per = -(-steps // plan.gsplits)
        assert -(-steps // per) == plan.gsplits
    assert set(BANKED_TILES) == {0, 1, 2}


def test_protocol_hooks_route_to_the_wrappers(monkeypatch):
    """Bank-stacked LoRA under the kernel backend returns the wrappers'
    results (and equals the reference hook, the gather-then-delta of
    ``Adapter.banked_delta``); the reference backend and quantized or
    stacked bases have no fused path.  Held against JAX's hooks."""
    a, b = _bank(10, 4, 32, 64, 4)
    x = _x(11, 3, 2, 32)
    w = _x(12, 32, 64)
    ids = np.asarray([2, 0, 3], np.int32)
    jl = JLora(a=jnp.asarray(a), b=jnp.asarray(b), alpha=8.0)
    tx, tw, ta, tb, tids = _t(x, w, a, b, ids)
    tl = LoraAdapter(ta, tb, 8.0)
    assert tl.rank == 4 and tl.scale == 2.0
    calls = []
    for name in ("banked_lora_delta", "banked_lora_linear"):
        fn = getattr(BG, name)
        monkeypatch.setattr(BG, name, lambda *args, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*args, **kw))
    ref = tl.banked_delta(tx, tids)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jl.banked_delta(jnp.asarray(x),
                                                jnp.asarray(ids))), **TOL)
    assert calls == []
    np.testing.assert_allclose(
        tl.banked_delta(tx, tids, backend="pallas").numpy(), ref.numpy(),
        **TOL)
    fused = tl.banked_linear(tx, tw, tids, backend="pallas")
    assert calls == ["banked_lora_delta", "banked_lora_linear"]
    np.testing.assert_allclose(fused.numpy(), (tx @ tw + ref).numpy(), **TOL)
    assert tl.banked_linear(tx, tw, tids) is None
    assert tl.banked_linear(tx, tw[None], tids, backend="pallas") is None


def test_cpu_tensors_launch_nothing():
    a, b = _bank(14, 3, 16, 24, 2)
    tx, ta, tb = _t(_x(15, 2, 3, 16), a, b)
    before = launch_counts()
    BG.banked_lora_delta(tx, ta, tb, torch.tensor([1, 2], dtype=torch.int32),
                         scale=1.0)
    assert launch_counts() == before
