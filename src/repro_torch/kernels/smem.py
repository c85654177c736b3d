"""Shared-memory budget of one thread block, and the tiles sized against
it, read from the card.

Takes the place of the JAX package's VMEM budget: the QuanTA chain
kernel's row tile (and the bf16 body's stage layouts and lane mappings)
and the attention kernels' working set are sized here
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
    "ChainStage",
    "ChainLayout",
    "ChainPlan",
    "chain_layout",
    "chain_column_table",
    "chain_output_table",
    "chain_tile",
    "chain_lane_cost",
    "chain_bf16_smem_bytes",
    "chain_chunks",
    "chain_plan",
    "chain_plan_ints",
    "attention_smem_bytes",
    "DecodePlan",
    "decode_plan",
    "decode_score_smem_bytes",
    "decode_value_smem_bytes",
    "decode_quant_score_smem_bytes",
    "decode_quant_value_smem_bytes",
    "flash_forward_panels",
    "flash_forward_smem_bytes",
    "QmmPlan",
    "qmm_smem_bytes",
    "qmm_decode_rows",
    "qmm_check_block",
    "quantized_matmul_plan",
    "BankedPlan",
    "banked_gather_plan",
    "banked_smem_bytes",
    "decode_k_splits",
    "LinearPlan",
    "quanta_linear_plan",
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


def chain_f32_plan(dims_in: Sequence[int],
                   shapes: Sequence[Sequence[int]],
                   pairs: Sequence[Tuple[int, int]], smem_limit: int,
                   cap: int = 8) -> Tuple[int, int]:
    """Row tile and tensor floats staged at once by the float32 chain body
    (``quanta_chain_kernel``).

    Every stage tensor staged whole (:func:`chain_rows_per_block`) where
    that fits a row tile; otherwise the largest row tile (at most
    ``cap``) beside which one ``a`` row of the widest stage fits (``in``
    rows of the transposed tensor: ``in * (om*on + 1)`` floats), the rest
    of the block's shared memory then holding as many ``a`` rows as fit:
    the kernel streams each such stage's tensor in chunks of whole ``a``
    rows, keeping each output's partial fp32 sum in its row buffer, so
    the sum runs over k ascending as when the tensor is whole (yi-6b's
    16-16-16: 256 x 257 floats a stage, 263 KB).  Returns ``(rows,
    t_floats)``: ``t_floats`` is the whole largest tensor when it fits."""
    cur = list(dims_in)
    d_max = math.prod(cur)
    full = a_row = cols = 0
    for (om, on, im, in_), (m, n) in zip(shapes, pairs):
        full = max(full, im * in_ * (om * on + 1))
        a_row = max(a_row, in_ * (om * on + 1))
        cols = max(cols, math.prod(cur) // (im * in_))
        cur[m], cur[n] = om, on
        d_max = max(d_max, math.prod(cur))
    words = chain_stage_words(dims_in, shapes, pairs)
    try:
        return chain_rows_per_block(d_max, words, 4, smem_limit, cap), full
    except ValueError:
        pass
    rows = chain_rows_per_block(d_max, a_row + 2 * cols, 4, smem_limit, cap)
    return rows, min(full, smem_limit // 4 - 2 * cols - 2 * rows * d_max)


# The bf16 chain body (``chain_bf16_kernel``): every stage reads its
# input with its pair axes minor, K contiguous values padded to a multiple
# of 8 per (row, column), and writes its output in the layout the next
# stage reads (the last stage: the canonical order).  The host plans the
# layouts; the kernel does the index arithmetic they give.
CHAIN_THREADS = 256
CHAIN_MAX_AXES = 8
CHAIN_MAX_COLS = CHAIN_MAX_AXES - 2
CHAIN_MAX_STAGES = 28
CHAIN_HEADER_INTS = 11        # the wire format of chain_plan_ints
CHAIN_STAGE_INTS = 16 + 2 * CHAIN_MAX_COLS
CHAIN_TILES = {0: (8, 8), 1: (4, 4)}   # variant -> (TM, TO) micro-tile
CHAIN_MAX_LO_SHIFT = 5        # the most low item bits on the output tile
                              # that bfc::unpack takes


class ChainStage(NamedTuple):
    k: int                    # im * in, the contraction
    kp: int                   # k padded to a multiple of 8 in the layout
    o: int                    # om * on, the outputs of a column
    on: int
    ncols: int                # columns: one index of every other axis
    col_dims: Tuple[int, ...]  # the column axes, slowest first
    col_out: Tuple[int, ...]  # their strides in the layout written
    dm: int                   # the pair axes' strides there
    dn: int
    t_off: int                # the tensor's element offset, resident area
    tab_off: int              # the column table's offset, in ints
    t_swz: int                # XOR mask of the tensor rows' 16-B chunks
    otab_off: int             # the output table's offset, in ints
    ncols_shift: int          # log2(ncols) when a power of two, else -1


class ChainLayout(NamedTuple):
    dims_in: Tuple[int, ...]  # x's canonical register
    d_out: int
    ld: int                   # row-buffer stride, in elements
    in_strides: Tuple[int, ...]   # x's axes' strides in stage 0's layout
    in_identity: bool         # stage 0's layout is x's canonical order
    t_elems: int              # every tensor, rows padded to kp
    t_max: int                # the largest tensor (the streamed area)
    tab_ints: int             # every stage's column table
    stages: Tuple[ChainStage, ...]


class ChainPlan(NamedTuple):
    rows: int                 # row tile
    resident: bool            # every tensor in shared memory at once
    variant: int              # micro-tile code (CHAIN_TILES)
    smem: int                 # bytes of a block
    layout: ChainLayout
    lanes: Tuple[Tuple[int, int], ...]  # per stage (lo_shift, rc_blocked)
    chunks: Tuple[int, ...]   # per stage, tensor rows (outputs) staged at
                              # once: all ``o`` unless the tensor streams
    t_elems: int              # elements of the tensor area


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _pair_minor(dims: Sequence[int], m: int, n: int,
                kp: int) -> Tuple[int, ...]:
    """Strides of a register with dims ``dims`` whose pair (m, n) is minor
    (``b`` fastest, then ``a``: k = a * in + b), padded to ``kp`` per
    column, the other axes slowest first in axis order."""
    st = [0] * len(dims)
    st[n], st[m] = 1, dims[n]
    acc = kp
    for ax in reversed(range(len(dims))):
        if ax not in (m, n):
            st[ax] = acc
            acc *= dims[ax]
    return tuple(st)


def _canonical(dims: Sequence[int]) -> Tuple[int, ...]:
    st, acc = [0] * len(dims), 1
    for ax in reversed(range(len(dims))):
        st[ax] = acc
        acc *= dims[ax]
    return tuple(st)


@functools.lru_cache(maxsize=None)
def chain_layout(dims_in: Tuple[int, ...],
                 shapes: Tuple[Tuple[int, int, int, int], ...],
                 pairs: Tuple[Tuple[int, int], ...]) -> ChainLayout:
    """The layouts of the bf16 chain body for stage tensors of ``shapes``
    ``(om, on, im, in)`` on ``pairs``: what each stage reads and where it
    writes each output, the tensor area and the column tables."""
    n_ax = len(dims_in)
    if not 1 <= n_ax <= CHAIN_MAX_AXES or not 1 <= len(pairs) <= \
            CHAIN_MAX_STAGES:
        raise ValueError(f"the chain kernel takes 1-{CHAIN_MAX_AXES} axes "
                         f"and 1-{CHAIN_MAX_STAGES} stages")
    cur = list(dims_in)
    kps = [_ceil8(im * i_n) for _, _, im, i_n in shapes]
    reads = _pair_minor(cur, *pairs[0], kps[0])
    in_strides = reads
    ld = math.prod(dims_in)
    stages, t_off, tab_off, t_max = [], 0, 0, 0
    for s, ((om, on, im, i_n), (m, n)) in enumerate(zip(shapes, pairs)):
        if (im, i_n) != (cur[m], cur[n]):
            raise ValueError(f"stage {s} tensor {(om, on, im, i_n)} does not "
                             f"fit axes {(m, n)} of {tuple(cur)}")
        k, kp = im * i_n, kps[s]
        cols = [ax for ax in range(n_ax) if ax not in (m, n)]
        ncols = math.prod(cur[ax] for ax in cols)
        ld = max(ld, ncols * kp)
        cur[m], cur[n] = om, on
        writes = (_pair_minor(cur, *pairs[s + 1], kps[s + 1])
                  if s + 1 < len(pairs) else _canonical(cur))
        chunks = kp // 8
        swz = chunks - 1 if k % 8 == 0 and chunks & (chunks - 1) == 0 else 0
        stages.append(ChainStage(
            k, kp, om * on, on, ncols, tuple(cur[ax] for ax in cols),
            tuple(writes[ax] for ax in cols), writes[m], writes[n], t_off,
            tab_off, swz, tab_off + ncols,
            ncols.bit_length() - 1 if ncols & (ncols - 1) == 0 else -1))
        t_off += om * on * kp
        t_max = max(t_max, om * on * kp)
        tab_off += ncols + om * on
    ld = _ceil8(max(ld, math.prod(cur)))
    return ChainLayout(tuple(dims_in), math.prod(cur), ld, in_strides,
                       in_strides == _canonical(dims_in),
                       t_off, t_max, tab_off, tuple(stages))


def chain_column_table(st: ChainStage) -> Tuple[int, ...]:
    """Where each column's outputs start in the layout the stage writes
    (the kernel's column table: the column index split over the column
    axes, the last fastest)."""
    out = []
    for c in range(st.ncols):
        off = 0
        for dim, stride in zip(reversed(st.col_dims), reversed(st.col_out)):
            off += (c % dim) * stride
            c //= dim
        out.append(off)
    return tuple(out)


def chain_output_table(st: ChainStage) -> Tuple[int, ...]:
    """Where output o = (i_m, i_n) of a column goes, from its column's
    start (the kernel's output table)."""
    return tuple((o // st.on) * st.dm + (o % st.on) * st.dn
                 for o in range(st.o))


def chain_tile(j: int, i: int, jj: int, n_mt: int, n_ot: int, tm: int,
               lo_shift: int, rc_blocked: int) -> Tuple[int, int]:
    """(row-column pair, output) of element (i, jj) of micro-tile item j:
    the low ``lo_shift`` bits of j pick the output tile, then the pair
    tile, then the output tile's high part; a tile's pairs are
    consecutive (``rc_blocked``) or ``n_mt`` apart, its outputs ``n_ot``
    apart."""
    lo = 1 << lo_shift
    rest = j >> lo_shift
    mt, ot = rest % n_mt, (rest // n_mt) * lo + (j & (lo - 1))
    return (mt * tm + i if rc_blocked else mt + i * n_mt), ot + jj * n_ot


def _wavefronts(words) -> int:
    """Shared-memory wavefronts of one warp access: the most distinct
    32-bit words in any of the 32 banks."""
    banks = {}
    for w in words:
        banks.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in banks.values())


def chain_lane_cost(st: ChainStage, rows: int, ld: int, tm: int, to: int,
                    lo_shift: int, rc_blocked: int) -> int:
    """Shared-memory wavefronts of warp 0's first micro-tile under a lane
    mapping: its tm * to bf16 stores, plus one chunk of 16-byte loads
    (activations and tensor rows, taken as four phases of eight lanes)
    times the k / 8 chunks.  The banking model, not a measurement."""
    m = rows * st.ncols
    n_mt, n_ot = -(-m // tm), -(-st.o // to)
    tab, otab = chain_column_table(st), chain_output_table(st)
    cost = 0
    for i in range(tm):
        for jj in range(to):
            words = []
            for j in range(32):
                rc, o = chain_tile(j, i, jj, n_mt, n_ot, tm, lo_shift,
                                   rc_blocked)
                rc, o = min(rc, m - 1), min(o, st.o - 1)
                words.append((rc // st.ncols * ld + tab[rc % st.ncols]
                              + otab[o]) // 2)
            cost += _wavefronts(words)
    loads = 0
    for idx in range(tm + to):
        chunks = []
        for j in range(32):
            rc, o = chain_tile(j, min(idx, tm - 1), max(idx - tm, 0), n_mt,
                               n_ot, tm, lo_shift, rc_blocked)
            if idx < tm:
                rc = min(rc, m - 1)
                chunks.append((rc // st.ncols * ld
                               + rc % st.ncols * st.kp) // 8)
            else:
                o = min(o, st.o - 1)
                chunks.append(o * st.kp // 8 + (o & st.t_swz))
        for p in range(4):
            groups = {}
            for c in set(chunks[8 * p:8 * p + 8]):
                groups.setdefault(c % 8, set()).add(c)
            loads += max(len(v) for v in groups.values())
    return cost + loads * -(-st.k // 8)


def _chain_lanes(st: ChainStage, rows: int, ld: int, tm: int,
                 to: int) -> Tuple[int, int]:
    """The lane mapping of a stage with the fewest modelled wavefronts
    (ties: the output tiles fastest, pairs n_mt apart)."""
    n_ot = -(-st.o // to)
    best = None
    for rc_blocked in (0, 1):
        for lo_shift in range(min(n_ot.bit_length(),
                                  CHAIN_MAX_LO_SHIFT + 1)):
            if n_ot % (1 << lo_shift) == 0:
                cost = chain_lane_cost(st, rows, ld, tm, to, lo_shift,
                                       rc_blocked)
                key = (cost, rc_blocked, -lo_shift)
                if best is None or key < best[0]:
                    best = (key, (lo_shift, rc_blocked))
    return best[1]


def chain_bf16_smem_bytes(rows: int, layout: ChainLayout,
                          resident: bool, t_elems: int | None = None) -> int:
    """Shared memory of a bf16 chain block (``bfc::smem_bytes``): the
    column tables, the tensor area (every tensor, or the largest when they
    stream stage by stage, or ``t_elems``), two bf16 row buffers of
    ``rows`` x ``ld``."""
    t = (t_elems if t_elems is not None
         else layout.t_elems if resident else layout.t_max)
    return (-(-4 * layout.tab_ints // 16) * 16 + -(-2 * t // 16) * 16
            + 4 * rows * layout.ld)


def chain_chunks(layout: ChainLayout, rows: int, smem_limit: int,
                 to: int) -> Tuple[int, ...] | None:
    """Per stage, the tensor rows (outputs) a block of ``rows`` rows
    stages at once when the largest stage tensor does not fit beside the
    row buffers: the whole tensor where it fits the room left, else the
    largest divisor of ``o`` that fits and is a multiple of the micro-tile's
    ``to`` outputs (equal chunks, one lane mapping).  ``None`` when some
    stage has no such chunk."""
    room = (smem_limit - -(-4 * layout.tab_ints // 16) * 16
            - 4 * rows * layout.ld) // 2
    out = []
    for st in layout.stages:
        if st.o * st.kp <= room:
            out.append(st.o)
            continue
        fits = [c for c in range(to, st.o, to)
                if st.o % c == 0 and c * st.kp <= room]
        if not fits:
            return None
        out.append(fits[-1])
    return tuple(out)


def _make_plan(layout: ChainLayout, rows: int, resident: bool,
               variant: int, chunks: Tuple[int, ...],
               t_elems: int) -> ChainPlan:
    tm, to = CHAIN_TILES[variant]
    lanes = tuple(_chain_lanes(st._replace(o=oc), rows, layout.ld, tm, to)
                  for st, oc in zip(layout.stages, chunks))
    return ChainPlan(rows, resident, variant,
                     chain_bf16_smem_bytes(rows, layout, resident, t_elems),
                     layout, lanes, chunks, t_elems)


@functools.lru_cache(maxsize=None)
def chain_plan(dims_in: Tuple[int, ...],
               shapes: Tuple[Tuple[int, int, int, int], ...],
               pairs: Tuple[Tuple[int, int], ...], smem_limit: int,
               cap: int = 8) -> ChainPlan:
    """The bf16 chain body's plan: the largest power-of-two row tile (at
    most ``cap``) whose block fits ``smem_limit`` with every stage tensor
    resident (llama2-7b's 16-8-8-4 scheme: 8 rows, 128 KB of row buffers,
    84 KB of tensors, 1.75 KB of tables); failing that, with the tensors
    staged one stage at a time; failing that, with a tensor too large for
    the block streamed in equal chunks of its rows (``chain_chunks``:
    mamba2-1.3b's widening x_proj chain, whose last stage tensor is 512 x
    512, at 8 rows in 8 chunks of 64 outputs), each output's sum still
    over all of k ascending.  8 x 8 micro-tiles from 4 rows up, except
    when a tensor streams: a chunk's 8 x 8 tiles would leave most of the
    256 threads idle, so 4 x 4."""
    layout = chain_layout(dims_in, shapes, pairs)
    whole = tuple(st.o for st in layout.stages)
    for resident in (True, False):
        t_elems = layout.t_elems if resident else layout.t_max
        rows = cap
        while rows >= 1:
            if chain_bf16_smem_bytes(rows, layout, resident) <= smem_limit:
                return _make_plan(layout, rows, resident,
                                  0 if rows >= 4 else 1, whole, t_elems)
            rows //= 2
    rows = cap
    while rows >= 1:
        chunks = chain_chunks(layout, rows, smem_limit, CHAIN_TILES[1][1])
        if chunks is not None:
            t_elems = max(oc * st.kp
                          for st, oc in zip(layout.stages, chunks))
            return _make_plan(layout, rows, False, 1, chunks, t_elems)
        rows //= 2
    raise ValueError(f"one row of width {layout.ld} and a chunk of a stage "
                     f"tensor of {layout.t_max} elements do not fit a "
                     f"block's {smem_limit} bytes of shared memory")


def chain_plan_ints(plan: ChainPlan) -> Tuple[int, ...]:
    """The plan as the kernel's entry point takes it (``bfc::unpack``): a
    header, x's dims and their strides in stage 0's layout, then each
    stage's fields with its column axes padded to ``CHAIN_MAX_COLS``."""
    lay = plan.layout
    out = [len(lay.dims_in), len(lay.stages), math.prod(lay.dims_in),
           lay.d_out, lay.ld, plan.rows, int(plan.resident),
           int(lay.in_identity), plan.t_elems, lay.tab_ints, plan.variant,
           *lay.dims_in, *lay.in_strides]
    for st, (lo_shift, rc_blocked), oc in zip(lay.stages, plan.lanes,
                                              plan.chunks):
        pad = [0] * (CHAIN_MAX_COLS - len(st.col_dims))
        out += [st.k, st.kp, st.o, st.on, st.ncols, len(st.col_dims), st.dm,
                st.dn, st.t_off if plan.resident else 0, st.tab_off, st.t_swz,
                st.otab_off, st.ncols_shift, lo_shift, rc_blocked, oc,
                *st.col_dims, *pad, *st.col_out, *pad]
    return tuple(out)


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
DEC_CODE_SCALES = 4    # scales of a K row a code stage holds (kQuantScales)


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


def decode_quant_score_smem_bytes(hd: int, g: int, stages: int,
                                  fmt: str) -> int:
    """Dynamic shared memory of a score block over NF4 or int8 code pools
    (``dec::quant_score_smem``): one bf16 K tile, the fp32 query, a ring of
    ``stages`` code stages (64 rows of codes, head_dim padded to 64 or
    128, and ``DEC_CODE_SCALES`` fp32 scales a row) and the codebook."""
    hdp = 64 if hd <= 64 else 128
    crow = hdp // 2 if fmt == "nf4" else hdp
    return (ATTN_KEYS * hdp * 2 + 4 * g * hdp
            + stages * ATTN_KEYS * (crow + 4 * DEC_CODE_SCALES) + 64)


def decode_quant_value_smem_bytes(g: int, fmt: str) -> int:
    """Dynamic shared memory of a value block over code pools
    (``dec::quant_value_smem``): the rows' value block plus, in each of its
    ``DEC_VALUE_STAGES`` stages, the codes of a ``DEC_SLICE``-dim V slice
    of 64 rows and the scale of each of its 8-dim chunks, and the
    codebook."""
    crow = DEC_SLICE // 2 if fmt == "nf4" else DEC_SLICE
    return (decode_value_smem_bytes(g)
            + DEC_VALUE_STAGES * ATTN_KEYS * (crow + 4 * (DEC_SLICE // 8))
            + 64)


class DecodePlan(NamedTuple):
    chunk: int        # keys of one score block, a multiple of 64
    splits: int       # score blocks over the extent
    stages: int       # K tiles in flight in a score block
    smem: int         # dynamic shared memory of a block over bf16 rows, in
                      # bytes (the larger pass's)
    quant_smem: int   # the same over NF4 or int8 codes (the larger format's)


@functools.lru_cache(maxsize=None)
def decode_plan(extent: int, hd: int, g: int) -> DecodePlan:
    """How the bf16 split decode (kernels 4 and 5 over bf16 rows, kernel 6
    over NF4 or int8 codes) walks a cache of ``extent`` positions
    (``S_max``, or ``n_b * bs`` for a pool) for ``g`` query heads per KV
    head of ``hd``: a score pass whose blocks take the extent's 64-key
    tiles in at most ``DEC_MAX_SPLITS`` chunks of equal size (at
    llama2-7b's 512 positions: 8 chunks of one tile), then a value pass
    whose blocks take ``DEC_SLICE`` head dims each and walk the slot's
    tiles.  The plan reads the static extent only (never the lengths,
    which live on the card, nor the pool's block size), so a pool and the
    dense cache gathered from it split alike, and codes split as rows do.
    float32 takes no plan: one attend_block block walks each slot."""
    tiles = max(1, -(-extent // ATTN_KEYS))
    per = -(-tiles // DEC_MAX_SPLITS)
    stages = min(DEC_STAGES, per)
    quant = max(max(decode_quant_score_smem_bytes(hd, g, stages, fmt),
                    decode_quant_value_smem_bytes(g, fmt))
                for fmt in ("nf4", "int8"))
    return DecodePlan(per * ATTN_KEYS, -(-tiles // per), stages,
                      max(decode_score_smem_bytes(hd, g, stages),
                          decode_value_smem_bytes(g)), quant)


FWD_ROWS = 64     # query rows of a bf16 forward block (one wgmma tile),
                  # as the plain version's query tiles
FWD_STAGES = 2    # K/V ring depth of the bf16 forward
FWD_MAX_HEAD_DIM = 256   # kMaxFwdHd: Griffin's head_dim


def flash_forward_panels(hd: int) -> int:
    """64-wide panels of head_dim in the bf16 forward's tiles (``HDP /
    64``): head_dim padded to 64, 128 or 256."""
    return 1 if hd <= 64 else 2 if hd <= 128 else 4


@functools.lru_cache(maxsize=None)
def flash_forward_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one bf16 flash-forward block
    (``fwd::Plan::BYTES``): 1 KB of alignment slack, the Q tile and
    ``FWD_STAGES`` K and V tiles of 64 keys, each with head_dim padded to
    64, 128 or 256 (rows of 128-byte swizzled panels), and the mbarriers.
    Up to 128 two blocks fit an SM; at 256 (161 KB) one does."""
    if hd % 8 or not 0 < hd <= FWD_MAX_HEAD_DIM:
        raise ValueError(f"the bf16 flash forward takes head_dim a multiple "
                         f"of 8 up to {FWD_MAX_HEAD_DIM}, got {hd}")
    panels = flash_forward_panels(hd)
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
BANKED_PREFILL, BANKED_DECODE, BANKED_F32 = 0, 1, 2   # variant codes
# variant code -> (block rows, block cols): the output tiles of the fused
# product
BANKED_TILES = {
    BANKED_PREFILL: (128, 256),   # bf16: wgmma, TMA ring (wgmma_gemm.cuh)
    BANKED_DECODE: (64, 64),      # bf16, <= 64 rows: 64 columns of W^T a
                                  # block, every row (wgmma's N: 8 or 64)
    BANKED_F32: (64, 64),         # float32, SIMT
}
BANKED_NARROW_ROWS = 64   # at most this many rows take the decode body
BANKED_GEMM_STAGES = 4    # TMA ring depth of both bf16 bodies
BANKED_DEC_BLOCKS_PER_SM = 4  # decode blocks an SM holds; K splits fill them
BANKED_STEP = 64          # K rows of a TMA step


BANKED_SHRINK_ROWS = 16   # rows of one slot per shrink block
BANKED_SHRINK_K = 64      # K rows of A per shrink step
BANKED_WAVES = 2          # shrink blocks wanted per SM before K is split


def decode_k_splits(d_in: int, tiles: int, sms: int) -> int:
    """K splits of the bf16 decode body of ``wg::decode_partials``
    (``csrc/wgmma_gemm.cuh``), which kernels 2 and 8 share: ``d_in`` in
    steps of ``BANKED_STEP`` split into non-empty parts until the ``tiles``
    column tiles times the splits fill ``BANKED_DEC_BLOCKS_PER_SM`` blocks
    on each SM and no more (4096 -> 4096: 64 tiles, 8 splits of 8 steps)."""
    steps = -(-d_in // BANKED_STEP)
    want = min(steps, max(1, BANKED_DEC_BLOCKS_PER_SM * sms // tiles))
    per = -(-steps // want)
    return -(-steps // per)


def banked_smem_bytes(variant: int, rows: int) -> int:
    """Dynamic shared memory of a fused bf16 block (``wg::GemmPlan::BYTES``
    and ``DecPlan<RN>::BYTES``): 1 KB of alignment slack, the ring of x and
    W tiles (prefill: 128 x 64 and 64 x 128; decode: a 64 x 64 W panel and
    the rows, 8 or 64, of 64 K each, 1 KB aligned), and the mbarriers.  The
    prefill epilogue reuses the ring for za and B[g]."""
    st = BANKED_GEMM_STAGES
    if variant == BANKED_PREFILL:
        bm, bn = BANKED_TILES[BANKED_PREFILL]
        return 1024 + st * (bm * 128 + 64 * 2 * bn) + 16 * st
    if variant == BANKED_DECODE:
        rn = 8 if rows <= 8 else 64
        return 1024 + st * (64 * 128 + _ceil_to(rn * 128, 1024)) + 16 * st
    return 0


class BankedPlan(NamedTuple):
    variant: int          # body code of the fused product
    tiles: int            # its output tiles (decode: per K split)
    splits: int           # K splits of the shrink (1: no partials)
    k_split: int          # K rows per split, a multiple of 64
    gsplits: int          # K splits of the decode body's product


@functools.lru_cache(maxsize=None)
def banked_gather_plan(n_slots: int, seq: int, d_in: int, d_out: int,
                       rank: int, bf16: bool, sms: int) -> BankedPlan:
    """Tiles of the banked-gather kernel for one problem shape.

    The TPU kernel holds a slot's whole ``d_in`` in VMEM and its JAX
    caller sends the shapes that overflow it (``banked_vmem_ok``) to the
    reference gather; here K is tiled, so every shape runs.  The fused
    product takes, in bf16, the ``wgmma`` prefill body (128 x 256 tiles,
    one block an SM) for more than 64 rows and the decode body for at most
    64, whose 64-column blocks split K until the SMs hold
    ``BANKED_DEC_BLOCKS_PER_SM`` each and no more (8 decode rows at 4096 ->
    4096: 64 tiles, 8 splits of 8 steps); float32 takes the 64 x 64 SIMT
    tile.  The shrink runs a block per 16 rows of a slot and splits K
    until there are two blocks per SM (a decode tick of 8 slots at d_in
    4096: 32 splits of 128 rows).
    """
    if rank > BANKED_MAX_RANK:
        raise ValueError(f"the banked-gather kernel takes rank <= "
                         f"{BANKED_MAX_RANK}, got {rank}")
    rows = n_slots * seq
    if not bf16:
        variant = BANKED_F32
    else:
        variant = (BANKED_DECODE if rows <= BANKED_NARROW_ROWS
                   else BANKED_PREFILL)
    bm, bn = BANKED_TILES[variant]
    col_tiles = -(-d_out // bn)
    tiles = col_tiles * (1 if variant == BANKED_DECODE else -(-rows // bm))
    gsplits = 1
    if variant == BANKED_DECODE:
        gsplits = decode_k_splits(d_in, tiles, sms)
    blocks = n_slots * -(-seq // BANKED_SHRINK_ROWS)
    steps = -(-d_in // BANKED_SHRINK_K)
    want = min(steps, max(1, -(-BANKED_WAVES * sms // blocks)))
    per = -(-steps // want)
    return BankedPlan(variant, tiles, -(-steps // per),
                      per * BANKED_SHRINK_K, gsplits)


# ---------------------------------------------------------------------------
# The adapted linear's base product (csrc/quanta_linear.cu)
# ---------------------------------------------------------------------------

LINEAR_PREFILL, LINEAR_DECODE, LINEAR_F32 = 0, 1, 2     # variant codes
LINEAR_PREFILL_BN = 256   # columns of a prefill tile (``kPrefillBN``)


class LinearPlan(NamedTuple):
    variant: int          # body code of the CUDA entry point
    gsplits: int          # K splits of the decode body (1 otherwise)


@functools.lru_cache(maxsize=None)
def quanta_linear_plan(rows: int, d_in: int, d_out: int, bf16: bool,
                       sms: int) -> LinearPlan:
    """Body and K split of kernel 2's base product for one problem shape.

    bf16 takes the ``wgmma`` prefill body (``wg::gemm_tile<256>``: 128 x
    256 tiles, one block an SM) for more than ``BANKED_NARROW_ROWS`` rows
    and the decode body (``wg::decode_partials``: 64 columns of W a block,
    every row, K split by :func:`decode_k_splits`, then an ordered sum of
    the splits) for at most that many, as kernel 8's fused product does;
    float32 takes the 64 x 64 SIMT tile.  At the main path's tick (8 rows
    of 4096 -> 4096): 64 column tiles, 8 splits of 8 steps.
    """
    if not bf16:
        return LinearPlan(LINEAR_F32, 1)
    if rows > BANKED_NARROW_ROWS:
        return LinearPlan(LINEAR_PREFILL, 1)
    tiles = -(-d_out // BANKED_TILES[BANKED_DECODE][1])
    return LinearPlan(LINEAR_DECODE, decode_k_splits(d_in, tiles, sms))
