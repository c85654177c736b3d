"""The bf16 chain body's stage-layout plan (``kernels/smem.py``
``chain_plan``) emulated in torch on the CPU: x scattered into stage 0's
layout, each stage reading its K values per (row, column) from the
padded layout and its tensor rows through the chunk swizzle, then storing
every output where the next stage reads it (the last stage in the
canonical order).  The emulation must equal ``apply_sequential`` bit for
bit, and must not read a position no stage wrote; a planted fault (one
stage storing its pair axes swapped) must not.  Also the plan's shared
memory and its wire format against ``csrc/quanta_apply.cu``."""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.factorize import pair_schedule
from repro_torch.core.quanta import (
    QuantaAdapter, _stage_product, apply_sequential,
)
from repro_torch.kernels import smem as S

H100_SMEM_BLOCK = 232448
CSRC = Path(S.__file__).resolve().parent.parent / "csrc"
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (d_in, d_out, dims_in, pairs): llama2-7b-proxy's and qwen2-0.5b's
# schemes, the q_proj and v_proj chains of yi-6b (16-16-16, GQA 4096 ->
# 512), phi3-medium-14b (16-8-8-5, 5120 -> 1280) and minicpm-2b
# (16-12-12), the v_proj chains of mixtral-8x7b (GQA 4096 -> 1024) and
# llama4-maverick (5120 -> 1024), recurrentgemma-2b's q_proj and
# rec_proj chain (16-16-10) and its v_proj chain (MQA 2560 -> 256),
# mamba2-1.3b's widening x_proj / z_proj chain (2048 -> 4096, its last
# stage tensor streamed in chunks) and its out_proj chain (4096 -> 2048),
# musicgen-large's q/v chain (16-16-8, 2048 -> 2048) and pixtral-12b's
# rectangular q_proj chain (5120 -> 4096: (40, 8, 4, 4) -> (32, 8, 4, 4)),
# every chain of the card tests
# (tests/test_torch_cuda.py CHAINS) and a 12-stage schedule
CHAINS = [
    (4096, 4096, (16, 8, 8, 4), None),
    (896, 896, (16, 8, 7), None),
    (4096, 4096, (16, 16, 16), None),
    (4096, 512, (64, 8, 8), None),
    (5120, 5120, (16, 8, 8, 5), None),
    (5120, 1280, (32, 8, 5, 4), None),
    (2304, 2304, (16, 12, 12), None),
    (4096, 1024, (64, 8, 8), None),
    (5120, 1024, (40, 8, 4, 4), None),
    (2560, 2560, (16, 16, 10), None),
    (2560, 256, (80, 8, 4), None),
    (2048, 4096, (16, 16, 8), None),
    (4096, 2048, (32, 16, 8), None),
    (2048, 2048, (16, 16, 8), None),
    (5120, 4096, (40, 8, 4, 4), None),
    (64, 64, (4, 4, 4), None),
    (24, 12, (4, 3, 2), None),
    (128, 256, (8, 4, 4), None),
    (64, 64, (4, 4, 2, 2), pair_schedule(4) * 2),
]


def _adapter(d_in, d_out, dims, pairs, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    ad = QuantaAdapter.create(gen, d_in, d_out, dims_in=dims, pairs=pairs,
                              noise_scale=0.05)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((7, d_in)).astype(np.float32))
    return x.to(dtype), [t.to(dtype) for t in ad.tensors], ad


def _plan(ad, limit=H100_SMEM_BLOCK, cap=8):
    shapes = tuple(tuple(t.shape) for t in ad.tensors)
    return S.chain_plan(ad.dims_in, shapes, tuple(ad.pairs), limit, cap)


def emulate(x, tensors, plan, swapped_stage=None):
    """The kernel's data movement over one tile of x's rows, with each
    stage's product in fp32 as the plain version computes it (in a 16-bit
    dtype summed over k ascending, ``_stage_product``): a streamed
    tensor's chunks of rows (``plan.chunks``) staged one after another,
    each chunk's outputs from its own tensor area."""
    lay = plan.layout
    rows, dt = x.shape[0], x.dtype
    nan = float("nan")
    buf = torch.full((rows, lay.ld), nan, dtype=dt)
    idx, f = [], torch.arange(math.prod(lay.dims_in))
    for dim in reversed(lay.dims_in):
        idx.append(f % dim)
        f = f // dim
    at = sum(i * s for i, s in zip(reversed(idx), lay.in_strides))
    buf[:, at] = x
    for s, (st, t, oc) in enumerate(zip(lay.stages, tensors, plan.chunks)):
        t = t.reshape(st.o, st.k)
        h = buf[:, :st.ncols * st.kp].reshape(rows, st.ncols, st.kp)
        h = h[..., :st.k].reshape(-1, st.k)
        ys = []
        for o0 in range(0, st.o, oc):
            # the tensor area: the chunk's row o (counted from o0), its
            # 16-byte chunk c at c ^ (o & t_swz)
            area = torch.full((oc, st.kp), nan, dtype=dt)
            o = torch.arange(oc)[:, None]
            k = torch.arange(st.k)[None, :]
            area[o, 8 * ((k // 8) ^ (o & st.t_swz)) + k % 8] = t[o0:o0 + oc]
            t_read = area[o, 8 * ((k // 8) ^ (o & st.t_swz)) + k % 8]
            ys.append(_stage_product(h, t_read))
        y = torch.cat(ys, dim=1)
        otab = torch.tensor(S.chain_output_table(st))
        if s == swapped_stage:      # (i_m, i_n) stored where (i_n, i_m) is
            o = torch.arange(st.o)
            otab = otab[(o % st.on) * (st.o // st.on) + o // st.on]
        where = (torch.tensor(S.chain_column_table(st))[:, None]
                 + otab[None, :]).reshape(-1)
        assert where.unique().numel() == where.numel(), "two outputs collide"
        buf = torch.full((rows, lay.ld), nan, dtype=dt)
        buf[:, where] = y.reshape(rows, -1)
    return buf[:, :lay.d_out]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out,dims,pairs", CHAINS)
def test_layout_plan_equals_apply_sequential(d_in, d_out, dims, pairs,
                                             dtype):
    x, tensors, ad = _adapter(d_in, d_out, dims, pairs, dtype)
    got = emulate(x, tensors, _plan(ad))
    assert not got.isnan().any(), "a stage read a position nobody wrote"
    assert torch.equal(got, apply_sequential(x, tensors, ad.dims_in,
                                             ad.pairs))


@pytest.mark.parametrize("d_in,d_out,dims,pairs", CHAINS)
def test_swapped_pair_axes_are_caught(d_in, d_out, dims, pairs, smoke):
    """One stage's output stored with its pair axes swapped leaves
    apply_sequential's result, and equals the planted fault the card run
    makes from the plain version (``chip_smoke.swapped_stage``)."""
    x, tensors, ad = _adapter(d_in, d_out, dims, pairs, torch.bfloat16)
    plan = _plan(ad)
    s = next(i for i, st in enumerate(plan.layout.stages)
             if st.on > 1 and st.o > st.on)
    got = emulate(x, tensors, plan, swapped_stage=s)
    assert not torch.equal(got, apply_sequential(x, tensors, ad.dims_in,
                                                 ad.pairs))
    assert torch.equal(got, apply_sequential(
        x, smoke.swapped_stage(tensors, s), ad.dims_in, ad.pairs))


def test_main_path_plan():
    """llama2-7b's 16-8-8-4 scheme: no padding, stage 0 reads x as it
    lies, 8 rows with every tensor resident (84 KB) in 218,880 bytes;
    every tensor row's chunks swizzled over the row's chunk count."""
    dims, pairs = (16, 8, 8, 4), pair_schedule(4)
    _, _, ad = _adapter(4096, 4096, dims, None, torch.bfloat16)
    plan = _plan(ad)
    lay = plan.layout
    assert (plan.rows, plan.resident, plan.variant) == (8, True, 0)
    # column and output tables: 448 ints each
    assert plan.smem == 896 * 4 + 43008 * 2 + 4 * 8 * 4096 == 220672
    assert lay.in_identity and lay.ld == 4096
    assert [st.k for st in lay.stages] == [32, 32, 64, 64, 128, 128]
    assert [st.kp for st in lay.stages] == [st.k for st in lay.stages]
    assert [st.t_swz for st in lay.stages] == [3, 3, 7, 7, 15, 15]
    # a decode tick: one row a block, 4 x 4 micro-tiles, 256 of them a stage
    one = _plan(ad, cap=1)
    assert (one.rows, one.variant) == (1, 1)
    tm, to = S.CHAIN_TILES[1]
    for st in lay.stages:
        assert (st.ncols // tm) * (st.o // to) == S.CHAIN_THREADS


# (d_in, d_out, dims_in) -> (rows, resident, smem) of the plan at the
# prefill row cap (8) and the decode tick's (1), at the H100's 232,448
# bytes of opt-in shared memory a block
DENSE_FAMILY_PLANS = {
    (4096, 4096, (16, 16, 16)): ((4, False, 199872), (1, False, 150720)),
    (4096, 512, (64, 8, 8)): ((8, True, 214080), (1, True, 99392)),
    (5120, 5120, (16, 8, 8, 5)): ((4, True, 178688), (1, True, 117248)),
    (5120, 1280, (32, 8, 5, 4)): ((8, True, 225472), (1, True, 53440)),
    (2304, 2304, (16, 12, 12)): ((4, True, 228064), (1, True, 200416)),
}


@pytest.mark.parametrize("key", list(DENSE_FAMILY_PLANS),
                         ids=lambda k: f"{k[0]}->{k[1]}")
def test_dense_family_plans(key):
    """The plans of yi-6b's, phi3-medium-14b's and minicpm-2b's q_proj and
    v_proj chains: yi-6b's 16-16-16 streams its tensors (four rows), its
    GQA v_proj contracts k = 512 in one stage, phi3's carries an axis of
    5 and pads a k of 20 to 24, and minicpm-2b's fits 4,384 bytes under
    the limit."""
    d_in, d_out, dims = key
    _, _, ad = _adapter(d_in, d_out, dims, None, torch.bfloat16)
    for cap, (rows, resident, smem) in zip((8, 1), DENSE_FAMILY_PLANS[key]):
        plan = _plan(ad, cap=cap)
        assert (plan.rows, plan.resident, plan.smem) == (rows, resident,
                                                         smem)
        assert plan.variant == (cap == 1)
    ks = [st.k for st in _plan(ad).layout.stages]
    kps = [st.kp for st in _plan(ad).layout.stages]
    if d_out == 512:
        assert ks == [64, 512, 64]
    if d_out == 1280:
        assert (ks[0], kps[0]) == (20, 24)
    if d_in == 2304:
        assert H100_SMEM_BLOCK - _plan(ad).smem == 4384


# the MoE family's new plans (its q_proj chains are yi-6b's 16-16-16 and
# phi3-medium-14b's 16-8-8-5): (rows, resident, smem, variant) at the
# prefill row cap (8) and the decode tick's (1)
MOE_FAMILY_PLANS = {
    (4096, 1024, (64, 8, 8)): ((2, True, 206400, 1), (1, True, 190016, 1)),
    (5120, 1024, (40, 8, 4, 4)): ((8, True, 192128, 0),
                                  (1, True, 48768, 1)),
}


@pytest.mark.parametrize("key", list(MOE_FAMILY_PLANS),
                         ids=lambda k: f"{k[0]}->{k[1]}")
def test_moe_family_plans(key):
    """mixtral-8x7b's v_proj chain (64, 8, 8) -> (16, 8, 8) contracts k =
    512 in its middle stage and, at the prefill cap, fits two rows with
    its tensors resident (4 x 4 micro-tiles); llama4-maverick's (40, 8, 4,
    4) -> (8, 8, 4, 4) carries an axis of 40 (k = 160) and fits eight."""
    d_in, d_out, dims = key
    _, _, ad = _adapter(d_in, d_out, dims, None, torch.bfloat16)
    for cap, want in zip((8, 1), MOE_FAMILY_PLANS[key]):
        plan = _plan(ad, cap=cap)
        assert (plan.rows, plan.resident, plan.smem, plan.variant) == want
    ks = [st.k for st in _plan(ad).layout.stages]
    assert ks == ([64, 512, 128] if d_in == 4096
                  else [16, 32, 160, 32, 32, 64])


@pytest.mark.parametrize("d_in,d_out,dims,pairs", CHAINS)
def test_lane_mappings_cover_every_output_once(d_in, d_out, dims, pairs):
    """Each stage's lane mapping (``chain_tile``) gives every (row-column
    pair, output) of the tile to exactly one item and element, at every
    row tile; the mapping the plan picks has no more modelled
    wavefronts than the output tiles fastest with pairs n_mt apart."""
    _, _, ad = _adapter(d_in, d_out, dims, pairs, torch.bfloat16)
    for cap in (1, 2, 8):
        plan = _plan(ad, cap=cap)
        tm, to = S.CHAIN_TILES[plan.variant]
        for st, (lo_shift, rc_blocked), oc in zip(
                plan.layout.stages, plan.lanes, plan.chunks):
            # a streamed tensor: the mapping of one chunk of oc outputs
            st = st._replace(o=oc)
            m = plan.rows * st.ncols
            n_mt, n_ot = -(-m // tm), -(-st.o // to)
            assert n_ot % (1 << lo_shift) == 0
            seen = [S.chain_tile(j, i, jj, n_mt, n_ot, tm, lo_shift,
                                 rc_blocked)
                    for j in range(n_mt * n_ot) for i in range(tm)
                    for jj in range(to)]
            inside = [(rc, o) for rc, o in seen if rc < m and o < st.o]
            assert sorted(inside) == [(rc, o) for rc in range(m)
                                      for o in range(st.o)]
            if n_ot & (n_ot - 1) == 0:
                default = S.chain_lane_cost(st, plan.rows, plan.layout.ld,
                                            tm, to, n_ot.bit_length() - 1, 0)
                assert S.chain_lane_cost(st, plan.rows, plan.layout.ld, tm,
                                         to, lo_shift, rc_blocked) <= default


@pytest.mark.parametrize("d_in,d_out,dims,pairs", CHAINS)
def test_plans_fit_a_block_and_pad_k_to_eight(d_in, d_out, dims, pairs):
    _, _, ad = _adapter(d_in, d_out, dims, pairs, torch.bfloat16)
    for cap in (1, 2, 4, 8):
        plan = _plan(ad, cap=cap)
        assert plan.smem <= H100_SMEM_BLOCK and plan.rows <= cap
        assert plan.smem == S.chain_bf16_smem_bytes(
            plan.rows, plan.layout, plan.resident, plan.t_elems)
        for st in plan.layout.stages:
            assert st.kp % 8 == 0 and st.k <= st.kp < st.k + 8
            assert st.ncols * st.kp <= plan.layout.ld
            assert st.t_off % 8 == 0


def test_wide_schedules_stream_their_tensors():
    """Twelve stages at llama2-7b's widths keep every tensor resident at 2
    rows, twenty-four stream theirs; a block of 99 KB streams the
    six-stage scheme's tensors one stage at a time at 2 rows; a block of
    48 KB, where the two 128 x 128 tensors do not fit beside two rows,
    streams them in four chunks of 32 outputs at two rows (4 x 4 tiles);
    a block without room for one row's buffers raises."""
    dims = (16, 8, 8, 4)
    _, _, ad = _adapter(4096, 4096, dims, pair_schedule(4) * 2,
                        torch.bfloat16)
    plan = _plan(ad)
    assert (plan.rows, plan.resident) == (2, True)
    _, _, ad = _adapter(4096, 4096, dims, pair_schedule(4) * 4,
                        torch.bfloat16)
    assert _plan(ad).resident is False      # 24 stages: 336 KB of tensors
    _, _, ad = _adapter(4096, 4096, dims, None, torch.bfloat16)
    plan = _plan(ad, limit=101_376)
    assert (plan.rows, plan.resident) == (2, False)
    assert plan.smem == 896 * 4 + 16384 * 2 + 4 * 2 * 4096
    plan = _plan(ad, limit=48 * 1024)
    assert (plan.rows, plan.resident, plan.variant) == (2, False, 1)
    assert plan.chunks == (32, 32, 64, 64, 32, 32)
    assert plan.t_elems == 32 * 128
    with pytest.raises(ValueError):
        _plan(ad, limit=16 * 1024)


def test_wire_format_mirrors_the_source():
    """``chain_plan_ints`` against ``bfc::unpack``: the header and stage
    lengths, the limits, and the shared-memory sum."""
    text = (CSRC / "quanta_apply.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))
    assert consts["kHeaderInts"] == str(S.CHAIN_HEADER_INTS)
    assert consts["kStageInts"] == "16 + 2 * kMaxCols"
    assert int(consts["kMaxAxes"]) == S.CHAIN_MAX_AXES
    assert int(consts["kMaxStages"]) == S.CHAIN_MAX_STAGES
    assert "kThreads = 256" in text and S.CHAIN_THREADS == 256
    assert ("return (size_t)align16(4 * p.tab_ints) + "
            "(size_t)align16(2 * p.t_elems) +\n         4 * (size_t)"
            "p.rows_per_block * p.ld;") in text
    _, _, ad = _adapter(896, 896, (16, 8, 7), None, torch.bfloat16)
    plan = _plan(ad)
    ints = S.chain_plan_ints(plan)
    n_ax, n_st = len(ad.dims_in), len(ad.pairs)
    assert len(ints) == S.CHAIN_HEADER_INTS + 2 * n_ax \
        + S.CHAIN_STAGE_INTS * n_st
    assert ints[:S.CHAIN_HEADER_INTS] == (
        n_ax, n_st, 896, 896, plan.layout.ld, plan.rows, 1,
        int(plan.layout.in_identity), plan.layout.t_elems,
        plan.layout.tab_ints, plan.variant)
    assert "chain_bf16_kernel<8, 8>" not in text  # launched by variant
    assert "bfc::launch<8, 8>" in text and "bfc::launch<4, 4>" in text
    assert S.CHAIN_TILES == {0: (8, 8), 1: (4, 4)}
