"""The tile and stage plans of ``repro_torch.kernels.smem`` for the bf16
flash forward, the quantized matmul and the split decode: their shared
memory, the body each row count takes, the K and key splits, and their
agreement with the constants of the CUDA sources they mirror.  CPU only:
the plans are plain Python."""

import inspect
import re
from pathlib import Path

import pytest

from repro_torch.kernels import smem as S

H100_SMS = 132
H100_SMEM_BLOCK = 232448          # 227 KB, what a block may opt in to
CSRC = Path(S.__file__).resolve().parent.parent / "csrc"

ROWS = (1, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 1001, 3072)
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (200, 24),
          (200, 300), (4096, 4104), (11008, 300), (64, 64))


def _constants(name):
    """``constexpr int`` names and values of a CUDA source."""
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)\b", text)}


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_flash_forward_plan_fits_two_blocks_an_sm(hd):
    # 228 KB an SM, 1 KB of it kept for each block
    assert 2 * (S.flash_forward_smem_bytes(hd) + 1024) <= 228 * 1024


@pytest.mark.parametrize("hd", [8, 24, 72, 120])
def test_flash_forward_pads_head_dim_to_one_or_two_panels(hd):
    # head_dim up to 64 takes one 64-wide panel, above it two
    assert S.flash_forward_smem_bytes(hd) == S.flash_forward_smem_bytes(
        64 if hd <= 64 else 128)


@pytest.mark.parametrize("hd", [0, 12, 264, 512])
def test_flash_forward_refuses_head_dims_it_cannot_take(hd):
    with pytest.raises(ValueError):
        S.flash_forward_smem_bytes(hd)


@pytest.mark.parametrize("hd", [136, 200, 256])
def test_flash_forward_takes_griffin_head_dim_in_one_block_an_sm(hd):
    """head_dim above 128 pads to 256: four 64-wide panels, 161 KB a
    block, so one block runs an SM (the source's register split assumes
    it) and it fits what a block may opt in to."""
    smem = S.flash_forward_smem_bytes(hd)
    assert S.flash_forward_panels(hd) == 4
    assert smem == S.flash_forward_smem_bytes(256) == 164896
    assert smem <= H100_SMEM_BLOCK < 2 * (smem + 1024) and smem + 1024 <= \
        228 * 1024


def test_decode_kernels_still_refuse_head_dim_256():
    """Kernels 4-6 keep their 128 limit (Griffin decodes its ring in plain
    PyTorch, as the JAX package does); kernel 3 takes 256."""
    from repro_torch.kernels import flash_attention as FA

    FA._check_heads(10, 1, 256, S.FWD_MAX_HEAD_DIM)
    for hd in (136, 256):
        with pytest.raises(ValueError, match="head_dim <= 128"):
            FA._check_heads(10, 1, hd)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        FA._check_heads(10, 1, 264, S.FWD_MAX_HEAD_DIM)
    c = _constants("flash_attention.cu")
    assert (c["kMaxHd"], c["kMaxFwdHd"]) == (128, S.FWD_MAX_HEAD_DIM)


def test_flash_forward_plan_mirrors_the_source():
    c = _constants("flash_attention.cu")
    assert (c["kFwdRows"], c["kFwdStages"]) == (S.FWD_ROWS, S.FWD_STAGES)
    assert c["kKeys"] == S.ATTN_KEYS == 64


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_qmm_plans_fit_a_block_and_split_into_non_empty_parts(rows, d_in,
                                                              d_out):
    for bf16 in (True, False):
        plan = S.quantized_matmul_plan(rows, d_in, d_out, bf16, H100_SMS)
        for fmt in ("nf4", "int8"):
            assert S.qmm_smem_bytes(plan.variant, rows, fmt) \
                <= H100_SMEM_BLOCK
        steps = -(-d_in // S.QMM_BK)
        per = -(-steps // plan.splits)
        assert 1 <= plan.splits <= steps
        # the entry point's split: every part holds at least one step
        assert (plan.splits - 1) * per < steps
        assert -(-steps // per) == plan.splits


@pytest.mark.parametrize("d_in,d_out", [(4096, 4096), (4096, 11008),
                                        (11008, 4096)])
@pytest.mark.parametrize("rows", [1, 8])
def test_qmm_decode_plans_give_several_blocks_per_sm(rows, d_in, d_out):
    plan = S.quantized_matmul_plan(rows, d_in, d_out, True, H100_SMS)
    assert plan.variant == S.QMM_DECODE
    blocks = -(-d_out // S.QMM_TILES[S.QMM_DECODE][1]) * plan.splits
    assert 2 * H100_SMS <= blocks <= S.QMM_WAVES[S.QMM_DECODE] * H100_SMS
    # and several of them fit an SM at once (228 KB, 1 KB kept per block)
    per_sm = (H100_SMEM_BLOCK + 1024) // (S.qmm_smem_bytes(
        plan.variant, rows) + 1024)
    assert per_sm >= 2


def test_qmm_main_path_plans():
    """The plans of llama2-7b's projections at a prefill wave and a tick."""
    plan = S.quantized_matmul_plan
    assert plan(3072, 4096, 4096, True, H100_SMS) == (S.QMM_PREFILL, 1)
    assert plan(3072, 4096, 11008, True, H100_SMS) == (S.QMM_PREFILL, 1)
    assert plan(3072, 11008, 4096, True, H100_SMS) == (S.QMM_PREFILL, 1)
    assert plan(8, 4096, 4096, True, H100_SMS) == (S.QMM_DECODE, 8)
    assert plan(8, 4096, 11008, True, H100_SMS) == (S.QMM_DECODE, 3)
    assert plan(8, 11008, 4096, True, H100_SMS) == (S.QMM_DECODE, 8)


@pytest.mark.parametrize("rows,variant", [
    (1, S.QMM_DECODE), (8, S.QMM_DECODE), (64, S.QMM_DECODE),
    (65, S.QMM_PREFILL), (128, S.QMM_PREFILL), (3072, S.QMM_PREFILL)])
def test_qmm_body_at_each_row_boundary(rows, variant):
    assert S.quantized_matmul_plan(rows, 4096, 4096, True,
                                   H100_SMS).variant == variant
    assert S.quantized_matmul_plan(rows, 4096, 4096, False,
                                   H100_SMS).variant == S.QMM_F32


@pytest.mark.parametrize("rows,n", [(1, 8), (8, 8), (9, 64), (16, 64),
                                    (17, 64), (32, 64), (33, 64), (64, 64)])
def test_qmm_decode_rows_round_up_to_a_wgmma_width(rows, n):
    assert S.qmm_decode_rows(rows) == n


def test_qmm_decode_rows_refuses_more_than_64():
    with pytest.raises(ValueError):
        S.qmm_decode_rows(65)


def test_qmm_block_size_rule():
    for bs in (8, 32, 64, 4096):
        S.qmm_check_block(bs, bf16=True)
    S.qmm_check_block(4, bf16=False)      # the float32 tile takes any
    with pytest.raises(ValueError):
        S.qmm_check_block(4, bf16=True)


def test_qmm_plan_mirrors_the_source():
    c = _constants("quantized_matmul.cu")
    bm, bn = S.QMM_TILES[S.QMM_PREFILL]
    assert (c["kPreBM"], 64 * c["kPreWGs"]) == (bm, bn)
    assert c["kDecBlocksPerSm"] == S.QMM_WAVES[S.QMM_DECODE]
    assert (c["kPreStagesNf4"], c["kPreStagesInt8"]) == (
        S.QMM_PREFILL_STAGES["nf4"], S.QMM_PREFILL_STAGES["int8"])
    assert c["kDecBN"] == S.QMM_TILES[S.QMM_DECODE][1]
    assert c["kDecStages"] == S.QMM_STAGES[S.QMM_DECODE]
    assert c["kMaxScaleRows"] == S.QMM_MAX_SCALE_ROWS
    assert c["kMinBlock"] == S.QMM_MIN_BLOCK
    assert (c["kPrefill"], c["kDecode"], c["kF32"]) == (
        S.QMM_PREFILL, S.QMM_DECODE, S.QMM_F32)
    # a 64-row step touches at most kMaxScaleRows blocks of >= kMinBlock
    for bs in range(S.QMM_MIN_BLOCK, 200):
        for k0 in range(0, 64 * 12, 64):
            rows = (k0 + 63) // bs - k0 // bs + 1
            assert rows <= S.QMM_MAX_SCALE_ROWS


def test_qmm_stage_sizes():
    # x 16 KB + codes 6 KB (NF4) or 12 KB (int8) + scales 6.75 KB + row
    # norms: prefill holds 7 or 6 such stages, decode 5 of 8 KB at 8 rows
    assert S.qmm_stage_bytes(128, 192, 32) == 29696
    assert S.qmm_stage_bytes(128, 192) == 35840
    assert S.qmm_smem_bytes(S.QMM_PREFILL, 3072, "nf4") == (
        1024 + 7 * 29696 + 112)
    assert S.qmm_smem_bytes(S.QMM_PREFILL, 3072, "int8") == (
        1024 + 6 * 35840 + 96)
    assert S.qmm_smem_bytes(S.QMM_DECODE, 8) == 1024 + 5 * 8192 + 80


# ------------------------------------------------ split decode plan
EXTENTS = (0, 1, 63, 64, 65, 200, 512, 1000, 1024, 1025, 4096, 32768)


@pytest.mark.parametrize("extent", EXTENTS)
def test_decode_plan_fits_a_block_and_covers_the_extent(extent):
    for hd in (1, 8, 12, 64, 72, 100, 128):
        for g in (1, 7, 8, 64):
            plan = S.decode_plan(extent, hd, g)
            assert plan.smem <= H100_SMEM_BLOCK
            assert plan.smem == max(
                S.decode_score_smem_bytes(hd, g, plan.stages),
                S.decode_value_smem_bytes(g))
            assert plan.chunk % S.ATTN_KEYS == 0
            assert 1 <= plan.splits <= S.DEC_MAX_SPLITS
            # every score block holds at least one key of the extent, and
            # all of them cover it
            assert plan.splits * plan.chunk >= extent
            assert (plan.splits - 1) * plan.chunk < max(extent, 1)
            assert plan.stages == min(S.DEC_STAGES,
                                      plan.chunk // S.ATTN_KEYS)


@pytest.mark.parametrize("n_b,bs", [(512, 1), (128, 4), (103, 5), (32, 16),
                                    (8, 64), (4, 128)])
def test_decode_plan_reads_the_extent_and_not_the_block_size(n_b, bs):
    """A pool's plan is the plan of its extent ``n_b * bs``, whatever the
    block size, so the pool and the dense cache gathered from it split
    alike (their kernels agree bit for bit on the card)."""
    assert list(inspect.signature(S.decode_plan).parameters) == [
        "extent", "hd", "g"]
    extent = n_b * bs
    plan = S.decode_plan(extent, 128, 1)
    assert plan.splits == min(S.DEC_MAX_SPLITS, -(-extent // 64))


def test_decode_plan_main_path():
    """llama2-7b's tick: 8 slots over 512 positions, 32 heads of 128, no
    GQA: 8 score chunks of one 64-key tile (the serving lengths give 832
    working score blocks of 2048), 17560 bytes a block over rows (the value
    pass's four-stage ring): the register budget's eight an SM fit; 29912
    over codes (the int8 value pass, its stages holding the codes and chunk
    scales too)."""
    plan = S.decode_plan(512, 128, 1)
    assert plan == S.DecodePlan(64, 8, 1, 17560, 29912)
    lens = (33, 100, 385, 512, 1, 64, 65, 200)
    assert 32 * sum(-(-n // plan.chunk) for n in lens) == 832
    assert (H100_SMEM_BLOCK + 1024) // (plan.smem + 1024) \
        >= S.DEC_BLOCKS_PER_SM
    # a longer cache takes longer chunks, never more than 16 of them
    assert S.decode_plan(4096, 128, 1)[:2] == (256, 16)
    assert S.decode_plan(1100, 128, 1)[:2] == (128, 9)


def test_decode_plan_mirrors_the_source():
    c = _constants("flash_attention.cu")
    assert c["kDecMaxSplits"] == S.DEC_MAX_SPLITS
    assert c["kDecStages"] == S.DEC_STAGES
    assert c["kDecSlice"] == S.DEC_SLICE
    assert c["kDecValueStages"] == S.DEC_VALUE_STAGES
    assert c["kDecBlocksPerSm"] == S.DEC_BLOCKS_PER_SM
    assert (c["kRows"], c["kKeys"]) == (S.ATTN_ROWS, S.ATTN_KEYS)
    # the source's shared-memory sums, term by term
    text = (CSRC / "flash_attention.cu").read_text()
    assert ("return (size_t)stages * kKeys * hdp * 2 + "
            "4 * (size_t)G * hdp;") in text
    assert ("return (size_t)kDecValueStages * (kKeys * kDecSlice * 2 + "
            "4 * G * kKeys) +\n         4 * (size_t)G * (kDecSlice + 2 + "
            "kDecValueStages);") in text
    # the source routes on the dtype as the wrappers do: its attend_block
    # launchers refuse bf16 rows, which split_decode_launch takes
    assert "return (int)cudaErrorInvalidValue;  // bf16 takes " \
        "split_decode_launch" in text


# ------------------------------------------------ chain and banked LoRA
def _chain(dims, pairs=None):
    from repro_torch.core.factorize import pair_schedule
    from repro_torch.core.quanta import tensor_shapes

    pairs = tuple(pairs or pair_schedule(len(dims)))
    return dims, tensor_shapes(dims, pairs), pairs


def _rect(dims_in, d0_out):
    """A rectangular chain: axis 0 maps ``dims_in[0] -> d0_out``."""
    from repro_torch.core.factorize import pair_schedule
    from repro_torch.core.quanta import tensor_shapes

    pairs = pair_schedule(len(dims_in))
    return dims_in, tensor_shapes(dims_in, pairs,
                                  (d0_out,) + tuple(dims_in[1:])), pairs


# the QuanTA schemes the port serves (llama2-7b-proxy's 16-8-8-4 on q/v,
# qwen2-0.5b's 16-8-7; yi-6b's 16-16-16 and its 4096 -> 512 v_proj,
# phi3-medium-14b's 16-8-8-5 and its 5120 -> 1280 v_proj, minicpm-2b's
# 16-12-12; mixtral-8x7b's 4096 -> 1024 and llama4-maverick's 5120 ->
# 1024 v_proj; recurrentgemma-2b's 16-16-10 on q_proj and rec_proj and
# its 2560 -> 256 v_proj; mamba2-1.3b's widening 2048 -> 4096 x_proj and
# z_proj and its 4096 -> 2048 out_proj, 16-16-8; musicgen-large's square
# 2048 -> 2048 q/v, 16-16-8, and pixtral-12b's rectangular 5120 -> 4096
# q_proj, whose v_proj is llama4-maverick's) and a 12-stage schedule
SERVED_CHAINS = [_chain((16, 8, 8, 4)), _chain((16, 8, 7)),
                 _chain((16, 8, 8, 4), _chain((16, 8, 8, 4))[2] * 2),
                 _chain((16, 16, 16)), _rect((64, 8, 8), 8),
                 _chain((16, 8, 8, 5)), _rect((32, 8, 5, 4), 8),
                 _chain((16, 12, 12)), _rect((64, 8, 8), 16),
                 _rect((40, 8, 4, 4), 8), _chain((16, 16, 10)),
                 _rect((80, 8, 4), 8), _rect((16, 16, 8), 32),
                 _rect((32, 16, 8), 16), _chain((16, 16, 8)),
                 _rect((40, 8, 4, 4), 32)]


@pytest.mark.parametrize("rows", [1, 8, 1001, 3072])
@pytest.mark.parametrize("chain", range(len(SERVED_CHAINS)))
def test_chain_plans_fit_a_block(chain, rows):
    """The bf16 chain body's plan at every row tile the wrapper asks for
    (``_row_cap``) fits an H100 block, and so does the float32 body's."""
    from repro_torch.kernels.quanta_apply import _row_cap, chain_widths

    dims, shapes, pairs = SERVED_CHAINS[chain]
    cap = _row_cap(rows, H100_SMS)
    plan = S.chain_plan(dims, shapes, pairs, H100_SMEM_BLOCK, cap)
    assert plan.smem <= H100_SMEM_BLOCK and 1 <= plan.rows <= cap
    _, d_max = chain_widths(dims, shapes, pairs)
    words = S.chain_stage_words(dims, shapes, pairs)
    f32, t_floats = S.chain_f32_plan(dims, shapes, pairs, H100_SMEM_BLOCK,
                                     cap)
    assert 1 <= f32 <= cap
    assert S.chain_smem_bytes(f32, d_max, words - _full_tensor(
        dims, shapes, pairs) + t_floats, 4) <= H100_SMEM_BLOCK


@pytest.mark.parametrize("cap", [1, 2, 4, 8])
@pytest.mark.parametrize("chain", range(len(SERVED_CHAINS)))
def test_chain_plan_ints_pass_the_sources_checks(chain, cap):
    """Every served chain's plan at every row cap passes the checks with
    which ``bfc::unpack`` refuses a plan (recurrentgemma-2b's 16-16-10 at
    one and two rows once took a lane mapping of ``lo_shift`` 6, which
    the kernel refuses: its decode tick failed at launch)."""
    dims, shapes, pairs = SERVED_CHAINS[chain]
    plan = S.chain_plan(dims, tuple(map(tuple, shapes)),
                        tuple(map(tuple, pairs)), H100_SMEM_BLOCK, cap)
    w = S.chain_plan_ints(plan)
    n_axes, n_stages, d_in, d_out, ld = w[:5]
    assert len(w) == (S.CHAIN_HEADER_INTS + 2 * n_axes
                      + S.CHAIN_STAGE_INTS * n_stages)
    assert ld % 8 == 0 and d_in <= ld and d_out <= ld
    t_elems, tab_ints, variant = w[8], w[9], w[10]
    to = S.CHAIN_TILES[variant][1]
    sp = S.CHAIN_HEADER_INTS + 2 * n_axes
    for i in range(n_stages):
        (k, kp, o, on, ncols, n_col, _, _, t_off, tab_off, t_swz, otab_off,
         ncols_shift, lo_shift, rc_blocked, oc) = w[sp:sp + 16]
        sp += S.CHAIN_STAGE_INTS
        assert 1 <= k <= kp and kp % 8 == 0 and o % on == 0
        assert 0 <= n_col <= S.CHAIN_MAX_COLS and ncols * kp <= ld
        assert oc >= 1 and o % oc == 0 and (oc == o or not w[6])
        assert t_off % 8 == 0 and t_off + oc * kp <= t_elems
        assert tab_off + ncols <= tab_ints and otab_off + o <= tab_ints
        assert not t_swz or (k % 8 == 0 and (t_swz + 1) * 8 <= kp)
        assert ncols_shift < 0 or ncols == 1 << ncols_shift
        assert 0 <= lo_shift <= S.CHAIN_MAX_LO_SHIFT
        assert (-(-oc // to)) % (1 << lo_shift) == 0
        assert rc_blocked in (0, 1)


def test_chain_lane_limit_mirrors_the_source():
    text = (CSRC / "quanta_apply.cu").read_text()
    assert (f"st.lo_shift < 0 || st.lo_shift > {S.CHAIN_MAX_LO_SHIFT} ||"
            in text)


def _full_tensor(dims, shapes, pairs):
    """Floats of the largest stage tensor, transposed and padded, as the
    float32 body stages it whole."""
    return max(im * i_n * (om * on + 1) for om, on, im, i_n in shapes)


def test_f32_chain_streams_only_what_does_not_fit():
    """The float32 body stages every tensor whole where that fits (the
    row tile of ``chain_rows_per_block``); yi-6b's 16-16-16 (256 x 257
    floats a stage) takes 4 rows and stages 6 of its 16 ``a`` rows of
    4,112 floats at once, mixtral-8x7b's v_proj (a middle stage of 512 x
    129 floats) 24 of its 64 ``a`` rows of 1,032, recurrentgemma-2b's
    16-16-10 (a last stage of 256 x 257 floats) 4 of its 16 ``a`` rows of
    4,112 at 8 rows of 2560; without room for one ``a`` row it raises."""
    streamed = (SERVED_CHAINS[3], SERVED_CHAINS[8], SERVED_CHAINS[10],
                SERVED_CHAINS[12], SERVED_CHAINS[13], SERVED_CHAINS[14],
                SERVED_CHAINS[15])
    for chain in SERVED_CHAINS:
        dims, shapes, pairs = chain
        if any(chain is c for c in streamed):
            continue
        words = S.chain_stage_words(dims, shapes, pairs)
        from repro_torch.kernels.quanta_apply import chain_widths

        d_max = chain_widths(dims, shapes, pairs)[1]
        assert S.chain_f32_plan(dims, shapes, pairs, H100_SMEM_BLOCK) == (
            S.chain_rows_per_block(d_max, words, 4, H100_SMEM_BLOCK),
            _full_tensor(dims, shapes, pairs))
    dims, shapes, pairs = SERVED_CHAINS[3]
    rows, t_floats = S.chain_f32_plan(dims, shapes, pairs, H100_SMEM_BLOCK)
    # 16 columns a stage: two offset tables of 16 ints
    assert rows == 4 and t_floats == H100_SMEM_BLOCK // 4 - 2 * 16 \
        - 2 * 4 * 4096 == 25312
    assert t_floats // (16 * 257) == 6
    with pytest.raises(ValueError):
        S.chain_f32_plan(dims, shapes, pairs, 2 * 4096 * 4 + 4112 * 4)
    dims, shapes, pairs = SERVED_CHAINS[8]
    rows, t_floats = S.chain_f32_plan(dims, shapes, pairs, H100_SMEM_BLOCK)
    # 64 columns in the widest stage: two offset tables of 64 ints
    assert rows == 4 and t_floats == H100_SMEM_BLOCK // 4 - 2 * 64 \
        - 2 * 4 * 4096 == 25216
    assert t_floats // (8 * 129) == 24 and _full_tensor(
        dims, shapes, pairs) == 512 * 129
    dims, shapes, pairs = SERVED_CHAINS[10]
    rows, t_floats = S.chain_f32_plan(dims, shapes, pairs, H100_SMEM_BLOCK)
    assert rows == 8 and t_floats == H100_SMEM_BLOCK // 4 - 2 * 16 \
        - 2 * 8 * 2560 == 17120
    assert t_floats // (16 * 257) == 4 and _full_tensor(
        dims, shapes, pairs) == 256 * 257


# mamba2-1.3b's chains (16-16-8): dims -> (bf16 plan at the prefill cap 8
# and the decode tick's 1 as (rows, chunks, smem), f32 (rows, floats))
MAMBA2_CHAINS = {
    12: (((8, (128, 256, 64), 200352), (1, (128, 256, 128), 151200)),
         (4, 25312)),
    13: (((4, (128, 128, 256), 198880), (1, (128, 128, 256), 149728)),
         (4, 25280)),
}


@pytest.mark.parametrize("chain", list(MAMBA2_CHAINS))
def test_mamba2_chains_stream_in_chunks_that_cover_each_output_once(chain):
    """mamba2-1.3b's widening x_proj / z_proj chain (16, 16, 8) -> (32, 16,
    8), whose last stage tensor is 512 x 512 (512 KB in bf16), and its
    out_proj chain (32, 16, 8) -> (16, 16, 8) plan within 227 KB in bf16
    and in float32.  The widening chain's bf16 plan streams that tensor in
    equal chunks of its rows (outputs): the chunks cover every output
    exactly once, in order, and each chunk holds whole rows of k; the
    narrowing chain's tensors all fit whole one stage at a time.  In
    float32 both stream ``a`` rows of their last stage (3 of 32 rows of
    16 x 513 floats; 6 of 16 rows of 16 x 257)."""
    dims, shapes, pairs = SERVED_CHAINS[chain]
    (prefill, decode), f32 = MAMBA2_CHAINS[chain]
    for cap, (rows, chunks, smem) in ((8, prefill), (1, decode)):
        plan = S.chain_plan(dims, tuple(map(tuple, shapes)),
                            tuple(map(tuple, pairs)), H100_SMEM_BLOCK, cap)
        assert (plan.rows, plan.chunks, plan.smem) == (rows, chunks, smem)
        assert plan.smem <= H100_SMEM_BLOCK and not plan.resident
        streams = any(oc < st.o for st, oc in zip(plan.layout.stages,
                                                  plan.chunks))
        assert streams == (chain == 12)
        assert plan.variant == (1 if streams or cap == 1 else 0)
        for st, oc in zip(plan.layout.stages, plan.chunks):
            starts = list(range(0, st.o, oc))
            covered = [o0 + i for o0 in starts for i in range(oc)]
            assert covered == list(range(st.o))
            assert oc * st.kp <= plan.t_elems
        ints = S.chain_plan_ints(plan)
        assert ints[8] == plan.t_elems
    big = plan.layout.stages[-1]
    if chain == 12:
        assert (big.o, big.k) == (512, 512) and plan.t_elems == 128 * 512
    assert S.chain_f32_plan(dims, shapes, pairs, H100_SMEM_BLOCK) == f32
    a_row = shapes[-1][3] * (shapes[-1][0] * shapes[-1][1] + 1)
    assert f32[1] // a_row == (3 if chain == 12 else 6)


# the frontends' chains: musicgen-large's q/v (16, 16, 8) (index 14) and
# pixtral-12b's q_proj (40, 8, 4, 4) -> (32, 8, 4, 4) (index 15): (bf16
# plan at the prefill cap 8 and the decode tick's 1 as (rows, resident,
# smem, variant), f32 (rows, floats))
FRONTEND_CHAINS = {
    14: (((4, True, 231584, 0), (1, True, 207008, 1)), (8, 25312)),
    15: (((4, False, 218112, 0), (1, False, 156672, 1)), (4, 16512)),
}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("chain", list(FRONTEND_CHAINS))
def test_frontend_chains_plan_within_a_block(chain, dtype):
    """musicgen-large's 16-16-8 q/v chain keeps its three tensors resident
    beside four rows (bf16: 864 bytes under the limit; one row at a
    decode tick), pixtral-12b's rectangular q_proj chain (App. B: axis 0
    maps 40 -> 32) stages its six tensors one at a time; every stage
    stages all its outputs at once (nothing streams in bf16).  In float32
    both stream ``a`` rows of their largest stage (256 x 257 floats)."""
    dims, shapes, pairs = SERVED_CHAINS[chain]
    bf16, f32 = FRONTEND_CHAINS[chain]
    if dtype == "f32":
        assert S.chain_f32_plan(dims, shapes, pairs, H100_SMEM_BLOCK) == f32
        assert f32[1] < _full_tensor(dims, shapes, pairs) == 256 * 257
        return
    for cap, want in zip((8, 1), bf16):
        plan = S.chain_plan(dims, tuple(map(tuple, shapes)),
                            tuple(map(tuple, pairs)), H100_SMEM_BLOCK, cap)
        assert (plan.rows, plan.resident, plan.smem, plan.variant) == want
        assert plan.chunks == tuple(st.o for st in plan.layout.stages)
    if chain == 14:
        assert H100_SMEM_BLOCK - bf16[0][2] == 864
    else:
        assert [st.o for st in plan.layout.stages] == [16, 32, 128, 32, 128,
                                                       256]


@pytest.mark.parametrize("cap", [1, 2, 4, 8])
def test_earlier_chains_keep_their_plans(cap):
    """No chain served before mamba2-1.3b streams a tensor: every stage
    of their plans stages all its outputs at once, resident or one stage
    at a time, with the area of the whole tensors or of the largest."""
    for dims, shapes, pairs in SERVED_CHAINS[:12]:
        plan = S.chain_plan(dims, tuple(map(tuple, shapes)),
                            tuple(map(tuple, pairs)), H100_SMEM_BLOCK, cap)
        assert plan.chunks == tuple(st.o for st in plan.layout.stages)
        assert plan.t_elems == (plan.layout.t_elems if plan.resident
                                else plan.layout.t_max)
        assert plan.variant == (0 if plan.rows >= 4 else 1)


def test_f32_chain_meta_mirrors_the_source():
    """The float32 launcher reads the staged floats after the stages and
    refuses fewer than one ``a`` row of the widest stage."""
    text = (CSRC / "quanta_apply.cu").read_text()
    assert "const int t_cap = sp[6 * p.n_stages];" in text
    assert "if (t_cap < a_row) return (int)cudaErrorInvalidValue;" in text
    src = (CSRC.parent / "kernels" / "quanta_apply.py").read_text()
    assert "meta.append(t_floats)" in src


@pytest.mark.parametrize("n,seq", [(8, 384), (8, 1), (4, 16), (5, 13),
                                   (97, 1), (3, 97)])
@pytest.mark.parametrize("d_in,d_out", [(4096, 4096), (4096, 4104),
                                        (896, 896), (4096, 11008)])
def test_banked_plans_fit_a_block(n, seq, d_in, d_out):
    """Kernel 8's fused bf16 bodies fit an H100 block at every serving
    shape, several decode blocks an SM at once; the decode body's K split
    fills at most the blocks the SMs hold."""
    plan = S.banked_gather_plan(n, seq, d_in, d_out, 16, True, H100_SMS)
    smem = S.banked_smem_bytes(plan.variant, n * seq)
    assert smem <= H100_SMEM_BLOCK
    if plan.variant == S.BANKED_DECODE:
        assert (H100_SMEM_BLOCK + 1024) // (smem + 1024) \
            >= S.BANKED_DEC_BLOCKS_PER_SM or n * seq > 8
        assert plan.tiles * plan.gsplits <= max(
            plan.tiles, S.BANKED_DEC_BLOCKS_PER_SM * H100_SMS)


def test_banked_plan_mirrors_the_source():
    """``banked_smem_bytes`` against ``wg::GemmPlan<BN>::BYTES`` and
    ``DecPlan<RN>::BYTES``, and the plan's constants against the CUDA
    sources'."""
    gemm = _constants("wgmma_gemm.cuh")
    assert gemm["kGemmBM"] == S.BANKED_TILES[S.BANKED_PREFILL][0] == 128
    assert gemm["kGemmStages"] == S.BANKED_GEMM_STAGES
    # the decode body of wg::decode_partials, which kernels 2 and 8 share
    assert gemm["kDecStages"] == S.BANKED_GEMM_STAGES
    assert gemm["kDecBN"] == S.BANKED_TILES[S.BANKED_DECODE][1]
    assert gemm["kDecBlocksPerSm"] == S.BANKED_DEC_BLOCKS_PER_SM
    text = (CSRC / "banked_gather.cu").read_text()
    assert "launch_prefill<%d, AT>(g, l, s)" % S.BANKED_TILES[
        S.BANKED_PREFILL][1] in text
    bn = S.BANKED_TILES[S.BANKED_PREFILL][1]
    # GemmPlan<BN>: 1 KB slack, stages of the x tile (128 rows of 128 B)
    # and the w tile (BN / 64 panels of 64 rows of 128 B), two mbarriers
    # a stage
    assert S.banked_smem_bytes(S.BANKED_PREFILL, 3072) == (
        1024 + 4 * (128 * 128 + (bn // 64) * 64 * 128) + 2 * 4 * 8)
    # DecPlan<RN>: a 64 x 64 W panel and RN rows of x, 1 KB aligned
    assert S.banked_smem_bytes(S.BANKED_DECODE, 8) == (
        1024 + 4 * (64 * 128 + 1024) + 2 * 4 * 8)
    assert S.banked_smem_bytes(S.BANKED_DECODE, 64) == (
        1024 + 4 * (64 * 128 + 64 * 128) + 2 * 4 * 8)


# ------------------------------------------------ the split helper, kernel 2
# banked_gather_plan's answers before its K split moved into
# decode_k_splits: (n_slots, seq, d_in, d_out, rank, bf16) -> plan
BANKED_BEFORE = {
    (8, 1, 4096, 4096, 16, True): (1, 64, 32, 128, 8),
    (8, 1, 4096, 4104, 16, True): (1, 65, 32, 128, 8),
    (4, 16, 896, 896, 8, True): (1, 14, 14, 64, 14),
    (97, 1, 4096, 11008, 16, True): (0, 43, 3, 1408, 1),
    (8, 1, 11008, 4096, 64, True): (1, 64, 29, 384, 8),
    (6, 1, 200, 96, 16, True): (1, 2, 4, 64, 4),
    (8, 384, 4096, 4096, 16, True): (0, 384, 2, 2048, 1),
    (3, 97, 4096, 4104, 16, True): (0, 51, 13, 320, 1),
    (8, 1, 4096, 4096, 16, False): (2, 64, 32, 128, 1),
}


@pytest.mark.parametrize("case", sorted(BANKED_BEFORE))
def test_split_helper_keeps_the_banked_plans(case):
    plan = S.banked_gather_plan(*case, H100_SMS)
    assert tuple(plan) == BANKED_BEFORE[case]
    if plan.variant == S.BANKED_DECODE:
        assert plan.gsplits == S.decode_k_splits(case[2], plan.tiles,
                                                 H100_SMS)


@pytest.mark.parametrize("rows,variant", [
    (1, S.LINEAR_DECODE), (8, S.LINEAR_DECODE), (63, S.LINEAR_DECODE),
    (64, S.LINEAR_DECODE), (65, S.LINEAR_PREFILL), (1001, S.LINEAR_PREFILL),
    (3072, S.LINEAR_PREFILL)])
def test_linear_plan_picks_the_body_at_the_64_row_edge(rows, variant):
    assert S.quanta_linear_plan(rows, 4096, 4096, True, H100_SMS).variant \
        == variant
    assert S.quanta_linear_plan(rows, 4096, 4096, False, H100_SMS) == \
        S.LinearPlan(S.LINEAR_F32, 1)


@pytest.mark.parametrize("rows", [1, 8, 64])
@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_linear_decode_splits_cover_k_once(rows, d_in, d_out):
    """The decode body's splits as ``launch_decode`` cuts K: ``per``
    64-row steps each, every split non-empty, every step in exactly one
    split; and at most the blocks the SMs hold at once."""
    plan = S.quanta_linear_plan(rows, d_in, d_out, True, H100_SMS)
    assert plan.variant == S.LINEAR_DECODE
    steps = -(-d_in // S.BANKED_STEP)
    per = -(-steps // plan.gsplits)
    owned = [z for k in range(steps) for z in range(plan.gsplits)
             if z * per <= k < (z + 1) * per]
    assert len(owned) == steps
    assert sorted(set(owned)) == list(range(plan.gsplits))
    tiles = -(-d_out // S.BANKED_TILES[S.BANKED_DECODE][1])
    assert tiles * plan.gsplits <= max(
        tiles, S.BANKED_DEC_BLOCKS_PER_SM * H100_SMS)


def test_linear_plan_main_path():
    """The tick of llama2-7b-proxy's q/v projections (8 rows of 4096 ->
    4096): 64 column tiles in 8 splits of 8 steps, 512 blocks, the four an
    SM that the decode body's registers allow on 132 SMs (528); the
    partial scratch is 8 x 8 x 4096 fp32, 1 MiB.  A prefill wave takes
    the wgmma tile body, as kernel 8's fused product does."""
    plan = S.quanta_linear_plan(8, 4096, 4096, True, H100_SMS)
    assert plan == S.LinearPlan(S.LINEAR_DECODE, 8)
    assert plan.gsplits * 8 * 4096 * 4 == 1 << 20
    assert S.quanta_linear_plan(3072, 4096, 4096, True, H100_SMS) == \
        S.LinearPlan(S.LINEAR_PREFILL, 1)


def test_dense_family_k_splits():
    """The K splits of the decode bodies at the dense family's tick (8
    rows): kernel 2 over the adapted projections, kernel 7 over every
    projection of yi-6b, phi3-medium-14b and minicpm-2b.  A prefill wave
    (3072 rows) takes one split but for yi-6b's 4096 -> 512 v_proj."""
    linear = {(4096, 4096): 8, (4096, 512): 64, (5120, 5120): 6,
              (5120, 1280): 20, (2304, 2304): 12}
    for (d_in, d_out), n in linear.items():
        assert S.quanta_linear_plan(8, d_in, d_out, True, H100_SMS) == \
            S.LinearPlan(S.LINEAR_DECODE, n)
        assert S.quanta_linear_plan(3072, d_in, d_out, True, H100_SMS) == \
            S.LinearPlan(S.LINEAR_PREFILL, 1)
    qmm = {(4096, 512): 64, (4096, 11008): 3, (11008, 4096): 8,
           (5120, 5120): 6, (5120, 1280): 20, (5120, 17920): 1,
           (17920, 5120): 6, (2304, 2304): 12, (2304, 5760): 5,
           (5760, 2304): 13}
    for (d_in, d_out), n in qmm.items():
        assert S.quantized_matmul_plan(8, d_in, d_out, True, H100_SMS) == \
            (S.QMM_DECODE, n)
        assert S.quantized_matmul_plan(3072, d_in, d_out, True,
                                       H100_SMS) == \
            (S.QMM_PREFILL, 2 if d_out == 512 else 1)


def test_moe_family_k_splits():
    """The K splits of the decode bodies at the MoE family's tick (8 rows)
    over its GQA v_proj and o_proj shapes: kernel 2 on mixtral-8x7b's 4096
    -> 1024 and llama4-maverick's 5120 -> 1024 v_proj, kernel 7 on the
    attention projections an NF4 base packs (the expert stacks stay
    unpacked).  A prefill wave (3072 rows) takes one split."""
    splits = {(4096, 1024): 32, (5120, 1024): 27, (4096, 4096): 8,
              (5120, 5120): 6}
    for (d_in, d_out), n in splits.items():
        assert S.quanta_linear_plan(8, d_in, d_out, True, H100_SMS) == \
            S.LinearPlan(S.LINEAR_DECODE, n)
        assert S.quantized_matmul_plan(8, d_in, d_out, True, H100_SMS) == \
            (S.QMM_DECODE, n)
        assert S.quanta_linear_plan(3072, d_in, d_out, True, H100_SMS) == \
            S.LinearPlan(S.LINEAR_PREFILL, 1)
        assert S.quantized_matmul_plan(3072, d_in, d_out, True,
                                       H100_SMS) == (S.QMM_PREFILL, 1)


def test_linear_plan_mirrors_the_source():
    """The variant codes and the prefill tile of ``csrc/quanta_linear.cu``,
    and its bodies on the shared mainloops of ``wgmma_gemm.cuh``."""
    c = _constants("quanta_linear.cu")
    assert c["kPrefillBN"] == S.LINEAR_PREFILL_BN == \
        S.BANKED_TILES[S.BANKED_PREFILL][1]
    text = (CSRC / "quanta_linear.cu").read_text()
    assert "wg::gemm_tile<kPrefillBN>" in text
    assert "wg::decode_partials<RN>" in text
    assert "if (dtype == 0 && variant == %d)" % S.LINEAR_F32 in text
    assert "if (variant == %d)\n    return launch_prefill" % \
        S.LINEAR_PREFILL in text
    assert "if (variant != %d || M > %d)" % (
        S.LINEAR_DECODE, S.BANKED_NARROW_ROWS) in text
    # the wmma loop is gone: every bf16 product runs on wgmma
    for name in ("tiled_gemm.cuh", "quanta_linear.cu", "banked_gather.cu"):
        assert "wmma" not in (CSRC / name).read_text().replace("wgmma", "")


# ------------------------------------------------ split decode over codes
@pytest.mark.parametrize("extent", EXTENTS)
def test_decode_plan_code_path_fits_a_block(extent):
    """The code path's blocks (kernel 6) fit an H100 block for every
    format at every head_dim and group the rows' plan takes, and the plan
    holds the larger of them."""
    for hd in (2, 8, 48, 64, 72, 100, 128):
        for g in (1, 7, 8, 64):
            plan = S.decode_plan(extent, hd, g)
            sizes = [f(fmt) for fmt in ("nf4", "int8") for f in (
                lambda fmt: S.decode_quant_score_smem_bytes(
                    hd, g, plan.stages, fmt),
                lambda fmt: S.decode_quant_value_smem_bytes(g, fmt))]
            assert plan.quant_smem == max(sizes) <= H100_SMEM_BLOCK
            assert plan.quant_smem > plan.smem


def test_decode_plan_code_path_mirrors_the_source():
    """``decode_quant_*_smem_bytes`` against ``dec::quant_score_smem`` and
    ``dec::quant_value_smem``, term by term, and the code stage's scale
    count against the source's."""
    c = _constants("flash_attention.cu")
    assert c["kQuantScales"] == S.DEC_CODE_SCALES
    text = (CSRC / "flash_attention.cu").read_text()
    assert ("const size_t crow = fmt == 0 ? hdp / 2 : hdp;\n"
            "  return kKeys * hdp * 2 + 4 * (size_t)G * hdp +\n"
            "         (size_t)stages * kKeys * (crow + 4 * kQuantScales) + "
            "64;") in text
    assert ("const size_t crow = fmt == 0 ? kDecSlice / 2 : kDecSlice;\n"
            "  return value_smem(G) +\n"
            "         (size_t)kDecValueStages * kKeys * (crow + 4 * "
            "(kDecSlice / 8)) + 64;") in text
    # the main path's blocks over NF4 and int8 codes
    assert S.decode_quant_score_smem_bytes(128, 1, 1, "nf4") == (
        64 * 128 * 2 + 4 * 128 + 64 * (64 + 16) + 64)
    assert S.decode_quant_value_smem_bytes(1, "int8") == (
        S.decode_value_smem_bytes(1) + 4 * 64 * (32 + 16) + 64)
    # bf16 codes take the split passes; the attend_block launcher is float32
    assert "if (dtype != 0) return (int)cudaErrorInvalidValue;" in text
