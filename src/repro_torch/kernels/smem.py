"""Shared-memory budget of one thread block, and the tiles sized against
it, read from the card.

Takes the place of the JAX package's VMEM budget: the QuanTA chain
kernel's row tile and the attention kernels' working set are sized here
against the block's shared-memory limit, the quantized matmul's K split
and the banked-gather kernel's column tile against the SM count; both
come from ``torch.cuda.get_device_properties``, once per device.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch

__all__ = [
    "DeviceLimits",
    "device_limits",
    "chain_stage_words",
    "chain_smem_bytes",
    "chain_rows_per_block",
    "attention_smem_bytes",
    "DecodePlan",
    "decode_plan",
    "decode_score_smem_bytes",
    "decode_value_smem_bytes",
    "flash_forward_smem_bytes",
    "QmmPlan",
    "qmm_smem_bytes",
    "qmm_decode_rows",
    "qmm_check_block",
    "quantized_matmul_plan",
    "BankedPlan",
    "banked_gather_plan",
]


class DeviceLimits(NamedTuple):
    sms: int          # streaming multiprocessors
    smem_block: int   # shared memory one block may opt in to, in bytes


@functools.lru_cache(maxsize=None)
def device_limits(device: torch.device) -> DeviceLimits:
    """The SM count and the per-block shared-memory opt-in limit of a CUDA
    device (above 48 KB a kernel reaches it only as dynamic shared memory,
    after ``cudaFuncSetAttribute``)."""
    props = torch.cuda.get_device_properties(device)
    return DeviceLimits(props.multi_processor_count,
                        props.shared_memory_per_block_optin)


def chain_stage_words(dims_in: Sequence[int],
                      shapes: Sequence[Sequence[int]],
                      pairs: Sequence[Tuple[int, int]]) -> int:
    """32-bit words the chain kernel stages beside its row buffers: the
    largest stage tensor ``T (om, on, im, in)`` in fp32, transposed to
    ``(im*in, om*on)`` with each row padded by one word, and two int
    offset tables as long as the most columns of any stage (a column is
    one index of every axis outside the stage's pair)."""
    cur = list(dims_in)
    t_words = cols = 0
    for (om, on, im, in_), (m, n) in zip(shapes, pairs):
        t_words = max(t_words, im * in_ * (om * on + 1))
        cols = max(cols, math.prod(cur) // (im * in_))
        cur[m], cur[n] = om, on
    return t_words + 2 * cols


def chain_smem_bytes(rows: int, d_max: int, stage_words: int,
                     itemsize: int) -> int:
    """Shared memory of the QuanTA chain kernel for a ``rows`` tile: two
    ping-pong row buffers of the widest register in the activation dtype
    and the staged words of :func:`chain_stage_words`."""
    return 2 * rows * d_max * itemsize + 4 * stage_words


def chain_rows_per_block(d_max: int, stage_words: int, itemsize: int,
                         smem_limit: int, cap: int = 8) -> int:
    """Largest power-of-two row tile (at most ``cap``) whose chain working
    set fits ``smem_limit`` bytes.  At d=4096 in bf16 with a 227 KB limit
    that is 8 rows (128 KB of row buffers plus 67 KB of staged tensor and
    offsets)."""
    rows = cap
    while rows > 1 and chain_smem_bytes(
        rows, d_max, stage_words, itemsize
    ) > smem_limit:
        rows //= 2
    if chain_smem_bytes(rows, d_max, stage_words, itemsize) > smem_limit:
        raise ValueError(
            f"one row of width {d_max} with {stage_words} staged words "
            f"does not fit a block's {smem_limit} bytes of shared memory"
        )
    return rows


# ---------------------------------------------------------------------------
# Attention kernels (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

ATTN_ROWS = 64    # query rows per block
ATTN_KEYS = 64    # keys per shared-memory tile


def attention_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one attention block (``smem_bytes`` in
    ``csrc/flash_attention.cu``): the fp32 query tile and key tile with
    rows padded by one word, the value tile, the score tile and two row
    statistics, plus the 16-entry NF4 codebook of the quantized decode."""
    return 4 * (ATTN_ROWS * (hd + 1) + ATTN_KEYS * (hd + 1) + ATTN_KEYS * hd
                + ATTN_ROWS * (ATTN_KEYS + 1) + 2 * ATTN_ROWS + 16)


DEC_MAX_SPLITS = 16  # chunks of the score pass over a slot's extent
DEC_STAGES = 2      # K tiles in flight in a score block
DEC_SLICE = 32      # head dims of a value block
DEC_VALUE_STAGES = 4  # tiles in a value block's ring
DEC_BLOCKS_PER_SM = 8  # the passes' register budget: 64 a thread


def decode_score_smem_bytes(hd: int, g: int, stages: int) -> int:
    """Dynamic shared memory of a score block of the split decode
    (``dec::score_smem`` in ``csrc/flash_attention.cu``): a ring of
    ``stages`` bf16 K tiles of 64 keys (rows of head_dim padded to 64 or
    128) and the fp32 query of the ``g`` query rows of the group."""
    hdp = 64 if hd <= 64 else 128
    return stages * ATTN_KEYS * hdp * 2 + 4 * g * hdp


def decode_value_smem_bytes(g: int) -> int:
    """Dynamic shared memory of a value block of the split decode
    (``dec::value_smem``): a ring of ``DEC_VALUE_STAGES`` tiles, each the
    bf16 ``DEC_SLICE``-dim slice of 64 V rows and the fp32 scores of the
    ``g`` query rows, then their accumulator slice, running max and
    denominator, and the rescale factor of each stage's tile."""
    return (DEC_VALUE_STAGES * (ATTN_KEYS * DEC_SLICE * 2 + 4 * g * ATTN_KEYS)
            + 4 * g * (DEC_SLICE + 2 + DEC_VALUE_STAGES))


class DecodePlan(NamedTuple):
    chunk: int        # keys of one score block, a multiple of 64
    splits: int       # score blocks over the extent
    stages: int       # K tiles in flight in a score block
    smem: int         # dynamic shared memory of a block, in bytes (the
                      # larger pass's)


@functools.lru_cache(maxsize=None)
def decode_plan(extent: int, hd: int, g: int) -> DecodePlan:
    """How the bf16 split decode (kernels 4 and 5 over bf16 rows) walks a
    cache of ``extent`` positions (``S_max``, or ``n_b * bs`` for a pool)
    for ``g`` query heads per KV head of ``hd``: a score pass whose blocks
    take the extent's 64-key tiles in at most ``DEC_MAX_SPLITS`` chunks of
    equal size (at llama2-7b's 512 positions: 8 chunks of one tile), then
    a value pass whose blocks take ``DEC_SLICE`` head dims each and walk
    the slot's tiles.  The plan reads the static extent only (never the
    lengths, which live on the card, nor the pool's block size), so a pool
    and the dense cache gathered from it split alike.  float32 rows and
    NF4 or int8 codes (kernel 6) take no plan: one attend_block block walks
    each slot."""
    tiles = max(1, -(-extent // ATTN_KEYS))
    per = -(-tiles // DEC_MAX_SPLITS)
    stages = min(DEC_STAGES, per)
    return DecodePlan(per * ATTN_KEYS, -(-tiles // per), stages,
                      max(decode_score_smem_bytes(hd, g, stages),
                          decode_value_smem_bytes(g)))


FWD_ROWS = 64     # query rows of a bf16 forward block (one wgmma tile),
                  # as the plain version's query tiles
FWD_STAGES = 2    # K/V ring depth of the bf16 forward (two blocks an SM)


@functools.lru_cache(maxsize=None)
def flash_forward_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one bf16 flash-forward block
    (``fwd::Plan::BYTES``): 1 KB of alignment slack, the Q tile and
    ``FWD_STAGES`` K and V tiles of 64 keys, each with head_dim padded to
    64 or 128 (rows of 128-byte swizzled panels), and the mbarriers."""
    if hd % 8 or not 0 < hd <= 128:
        raise ValueError(f"the bf16 flash forward takes head_dim a multiple "
                         f"of 8 up to 128, got {hd}")
    panels = 1 if hd <= 64 else 2
    return (1024 + FWD_ROWS * 128 * panels
            + FWD_STAGES * 2 * ATTN_KEYS * 128 * panels + 2 * FWD_STAGES * 8)


# ---------------------------------------------------------------------------
# Quantized matmul (csrc/quantized_matmul.cu)
# ---------------------------------------------------------------------------

QMM_BK = 64       # K rows per step: a multiple of the two rows of an NF4
                  # byte, and of the quant block where that divides 64
QMM_PREFILL, QMM_DECODE, QMM_F32 = 0, 1, 2     # variant codes
# variant code -> (block rows, block cols) of its output tile; the decode
# body's rows are the problem's, rounded up to QMM_DECODE_ROWS
QMM_TILES = {
    QMM_PREFILL: (128, 192),    # bf16, wgmma, three consumer warpgroups
    QMM_DECODE: (64, 64),       # bf16, wgmma on out^T: 64 columns
    QMM_F32: (64, 64),          # float32, SIMT
}
# wgmma N of the decode body: 8 for a decode tick of at most 8 rows, 64
# for 9-64 rows
QMM_DECODE_ROWS = (8, 64)
QMM_NARROW_ROWS = QMM_DECODE_ROWS[-1]  # at most this many take decode
QMM_STAGES = {QMM_DECODE: 5}                   # load ring depths
QMM_PREFILL_STAGES = {"nf4": 7, "int8": 6}
QMM_MAX_SCALE_ROWS = 9    # scale rows a 64-row step touches, blocks >= 8
QMM_MIN_BLOCK = 8         # the bf16 bodies stage at most 9 scale rows
# blocks wanted per SM before K is split: the prefill body holds an SM
# alone (512 threads), the decode body wants bytes in flight from several
QMM_WAVES = {QMM_PREFILL: 1, QMM_DECODE: 4, QMM_F32: 2}


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def qmm_stage_bytes(tile_rows: int, tile_cols: int,
                    code_rows: int = QMM_BK) -> int:
    """One ring stage of the bf16 bodies (``Stage`` in the CUDA source):
    the swizzled x tile (128 B a row), the code tile (``code_rows`` rows of
    ``tile_cols`` bytes: 32 for NF4, 64 for int8), the scale rows and 64
    row norms, rounded up to 1 KB."""
    return _ceil_to(tile_rows * 128 + code_rows * tile_cols
                    + QMM_MAX_SCALE_ROWS * tile_cols * 4 + QMM_BK * 4, 1024)


def qmm_decode_rows(rows: int) -> int:
    """The decode body's wgmma N for ``rows`` rows (at most 64)."""
    for n in QMM_DECODE_ROWS:
        if rows <= n:
            return n
    raise ValueError(f"the decode body takes at most {QMM_NARROW_ROWS} "
                     f"rows, got {rows}")


def qmm_smem_bytes(variant: int, rows: int, fmt: str = "nf4") -> int:
    """Dynamic shared memory of one quantized-matmul block (``Pre::BYTES``
    and ``DecPlan::BYTES``): 1 KB of alignment slack, the load ring of x,
    codes, scales and row norms, and its mbarriers.  Both
    bf16 bodies decode the weights into registers.  The float32 tile's
    shared memory is static."""
    if variant == QMM_F32:
        return 0
    bm, bn = QMM_TILES[variant]
    if variant == QMM_PREFILL:
        stages = QMM_PREFILL_STAGES[fmt]
        code_rows = QMM_BK // 2 if fmt == "nf4" else QMM_BK
        return 1024 + stages * qmm_stage_bytes(bm, bn, code_rows) \
            + 2 * stages * 8
    stages = QMM_STAGES[variant]
    return 1024 + stages * qmm_stage_bytes(qmm_decode_rows(rows), bn) \
        + 2 * stages * 8


def qmm_check_block(block_size: int, bf16: bool) -> None:
    """The bf16 bodies stage at most ``QMM_MAX_SCALE_ROWS`` scale rows a
    step, so they take quant blocks of at least 8 rows; raises below."""
    if bf16 and block_size < QMM_MIN_BLOCK:
        raise ValueError(f"the bf16 quantized matmul takes block sizes >= "
                         f"{QMM_MIN_BLOCK}, got {block_size}")


class QmmPlan(NamedTuple):
    variant: int          # body code of the CUDA entry point
    splits: int           # K splits (1: no partials)


@functools.lru_cache(maxsize=None)
def quantized_matmul_plan(rows: int, d_in: int, d_out: int, bf16: bool,
                          sms: int) -> QmmPlan:
    """Body and K split of the quantized matmul for one problem shape.

    bf16 takes the prefill body (tiles of 128 rows x 192 columns, one
    block an SM) for more than 64 rows and the decode body (64 columns a
    block) for at most 64; float32 the 64 x 64 SIMT tile.
    When the output tiles give fewer blocks than ``QMM_WAVES`` per SM, K
    is split into non-empty parts: for prefill and float32 until there are
    that many, for decode into as many as the SMs hold at once
    (``kDecBlocksPerSm``: four), so that no block waits for a second wave
    (a decode tick at 4096 -> 4096: 64 tiles, 8 splits of 8 steps; 4096 ->
    11008: 172 tiles, 3 splits; 11008 -> 4096: 8 splits of 22 steps).
    """
    if not bf16:
        variant = QMM_F32
    else:
        variant = QMM_DECODE if rows <= QMM_NARROW_ROWS else QMM_PREFILL
    bm, bn = QMM_TILES[variant]
    tiles = -(-d_out // bn) * (1 if variant == QMM_DECODE else -(-rows // bm))
    steps = -(-d_in // QMM_BK)
    if variant == QMM_DECODE:
        # as many blocks as the SMs hold at once, never a second wave
        want = (QMM_WAVES[variant] * sms) // tiles
    else:
        want = -(-QMM_WAVES[variant] * sms // tiles)
    want = min(steps, max(1, want))
    per = -(-steps // want)
    return QmmPlan(variant, -(-steps // per))


# ---------------------------------------------------------------------------
# Banked-gather LoRA (csrc/banked_gather.cu)
# ---------------------------------------------------------------------------

BANKED_MAX_RANK = 64      # the shrink kernel stages (64, rank) fp32 A tiles
# variant code -> (block rows, block cols): the output tiles of the fused
# expand GEMM (``ExpandTile`` and the float32 tile in the CUDA source),
# each with its K step in static shared memory under 48 KB
BANKED_TILES = {
    0: (128, 128),    # bf16, many rows: 4 x 2 warps of 32 x 64
    1: (16, 32),      # bf16, few rows: 2 column warps x 4 K slices
    2: (64, 64),      # float32, SIMT
}
BANKED_NARROW_ROWS = 64   # at most this many rows take a 16-row tile


BANKED_SHRINK_ROWS = 16   # rows of one slot per shrink block
BANKED_SHRINK_K = 64      # K rows of A per shrink step
BANKED_WAVES = 2          # shrink blocks wanted per SM before K is split


class BankedPlan(NamedTuple):
    variant: int          # tile code of the fused product
    tiles: int            # its output tiles, one block each
    splits: int           # K splits of the shrink (1: no partials)
    k_split: int          # K rows per split, a multiple of 64


@functools.lru_cache(maxsize=None)
def banked_gather_plan(n_slots: int, seq: int, d_in: int, d_out: int,
                       rank: int, bf16: bool, sms: int) -> BankedPlan:
    """Tiles of the banked-gather kernel for one problem shape.

    The TPU kernel holds a slot's whole ``d_in`` in VMEM and its JAX
    caller sends the shapes that overflow it (``banked_vmem_ok``) to the
    reference gather; here K is tiled, so every shape runs.  The fused
    product takes, in bf16, the 128 x 128 tile for many rows and the
    16 x 32 tile for at most 64 (8 decode rows at d_out 4096: 128 blocks
    on 132 SMs, each streaming its stripe of W); float32 takes the
    64 x 64 SIMT tile.  The shrink runs a block per 16
    rows of a slot and splits K until there are two blocks per SM (a
    decode tick of 8 slots at d_in 4096: 33 splits of 128 rows).
    """
    if rank > BANKED_MAX_RANK:
        raise ValueError(f"the banked-gather kernel takes rank <= "
                         f"{BANKED_MAX_RANK}, got {rank}")
    rows = n_slots * seq

    def tiles(v):
        bm, bn = BANKED_TILES[v]
        return -(-rows // bm) * -(-d_out // bn)

    variant = 2 if not bf16 else (0 if rows > BANKED_NARROW_ROWS else 1)
    blocks = n_slots * -(-seq // BANKED_SHRINK_ROWS)
    steps = -(-d_in // BANKED_SHRINK_K)
    want = min(steps, max(1, -(-BANKED_WAVES * sms // blocks)))
    per = -(-steps // want)
    return BankedPlan(variant, tiles(variant), -(-steps // per),
                      per * BANKED_SHRINK_K)
