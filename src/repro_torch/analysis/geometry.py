"""Launch geometry of the port's CUDA entry points, modelled on the host.

For each ``extern "C"`` entry point under ``csrc/`` a plain-Python model
repeats what the launcher computes from the ints it was given (every
``dim3`` grid, thread count and dynamic shared-memory size of its ``<<<``
sites, in ``csrc/geometry.cuh``'s order) and, for every block, the output
tile it writes and the input ranges it reads (rows, K ranges, KV
positions, the page ids and bank rows it gathers).  The models read a
:class:`~repro_torch.analysis.kernels.LaunchRecord`: the ints exactly as
a wrapper passed them, and each pointer operand's shape and dtype.

The shared-memory sizes are written out here as the CUDA sources sum
them; each launch also carries the ``kernels/smem.py`` budget its wrapper
dispatches on (``budget``), and the checker holds the two equal.  On the
card the ``*_describe`` exports give the C++ side's numbers, held equal to
these (``check_kernels(card=True)``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels import smem as S

__all__ = ["Box", "Gather", "Launch", "MODELS", "OUTPUTS", "model"]

# block threads and tiles as the CUDA sources set them
ATTN_THREADS = 256        # flash_attention.cu kThreads
FWD_THREADS = 256         # fwd::kFwdThreads
FWD_PANEL = 64 * 128      # fwd::Plan::PANEL: 64 rows of 128 B
DEC_THREADS = 128         # dec::kDecThreads
CHAIN_F32_THREADS = 512   # quanta_apply.cu kThreads (the float32 body)
CODEBOOK_BYTES = 16 * 4   # the paged float32 kernel's static codebook
GEMM_BM = 128             # wg::kGemmBM
GEMM_THREADS = 384        # wg::kGemmThreads
GEMM_STAGES = 4           # wg::kGemmStages
WG_DEC_BN = 64            # wg::kDecBN
WG_DEC_THREADS = 160      # wg::kDecThreads
WG_DEC_STAGES = 4         # wg::kDecStages
LINEAR_BN = 256           # quanta_linear.cu kPrefillBN
SIMT = 64                 # tiled::SIMT_BM, SIMT_BN
SIMT_THREADS = 256
QMM_PRE_BM, QMM_PRE_BN, QMM_PRE_THREADS = 128, 192, 512
QMM_DEC_BN, QMM_DEC_THREADS, QMM_DEC_STAGES = 64, 128, 5
QMM_F32_THREADS = 256
QMM_REDUCE_CAP = 4096     # reduce_splits_kernel's most blocks
ELEMENTWISE = 256         # threads (and elements) of the 1-D kernels
SHRINK_ROWS = 16          # banked_gather.cu SR
SHRINK_K = 64             # SK

# the pointer arguments each entry point writes, and those of them that
# are its final output (every element of which a launch must write)
OUTPUTS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "flash_forward_launch": (("o",), ("o",)),
    "flash_decode_launch": (("o",), ("o",)),
    "paged_decode_launch": (("o",), ("o",)),
    "split_decode_launch": (("o", "scores"), ("o",)),
    "quant_split_decode_launch": (("o", "scores"), ("o",)),
    "quanta_apply_launch": (("out",), ("out",)),
    "quanta_chain_bf16_launch": (("out",), ("out",)),
    "quanta_linear_gemm_launch": (("out", "part"), ("out",)),
    "quantized_matmul_launch": (("out", "partial"), ("out",)),
    "banked_lora_launch": (("out", "za", "zpart", "gpart"), ("out",)),
}


@dataclasses.dataclass
class Box:
    """Tiles of one tensor, one per row of ``lo``/``hi``: the half-open
    ranges ``[lo, hi)`` of each axis of ``view`` (the tensor read as that
    shape).  ``hi`` is clipped to ``view``; ``lo`` is left as the block
    computes it, so a tile that starts outside shows."""

    tensor: str
    view: Tuple[int, ...]
    lo: np.ndarray        # (n, rank) int64
    hi: np.ndarray


@dataclasses.dataclass
class Gather:
    """Indices a launch reads from a tensor (page ids of a block table, an
    adapter bank's rows), each to lie in ``[0, limit)``."""

    what: str
    ids: np.ndarray
    limit: int


@dataclasses.dataclass
class Launch:
    """One ``<<<`` site's launch: ``tiles()`` gives its writes, reads and
    gathers (computed when asked: a grid too large to enumerate is refused
    before)."""

    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int                       # dynamic shared memory, bytes
    budget: Optional[int]           # what kernels/smem.py says it is
    tiles: Callable[[], Tuple[List[Box], List[Box], List[Gather]]]
    static_smem: int = 0            # beside it (in the budget)

    @property
    def points(self) -> int:
        return math.prod(self.grid)

    def ints(self) -> Tuple[int, ...]:
        """As a ``*_describe`` export writes it."""
        return (*self.grid, self.threads, self.smem)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _blocks(grid) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    gx, gy, gz = grid
    z, y, x = np.meshgrid(np.arange(gz, dtype=np.int64),
                          np.arange(gy, dtype=np.int64),
                          np.arange(gx, dtype=np.int64), indexing="ij")
    return x.ravel(), y.ravel(), z.ravel()


def box(tensor: str, view: Sequence[int], lo: Sequence, size: Sequence
        ) -> Box:
    """Tiles starting at ``lo`` (per axis: an int or an array over the
    blocks) of ``size`` (likewise), clipped to ``view``."""
    n = max([np.size(v) for v in lo] + [np.size(v) for v in size] + [1])
    lo_a = np.stack([np.broadcast_to(np.asarray(v, np.int64), (n,))
                     for v in lo], axis=1)
    size_a = np.stack([np.broadcast_to(np.asarray(v, np.int64), (n,))
                       for v in size], axis=1)
    view = tuple(int(v) for v in view)
    hi = np.minimum(lo_a + size_a, np.asarray(view, np.int64))
    return Box(tensor, view, lo_a, hi)


def _launch(kernel, grid, threads, smem, budget, tiles, static_smem=0):
    grid = tuple(int(g) for g in grid) + (1,) * (3 - len(grid))
    return Launch(kernel, grid, int(threads), int(smem), budget, tiles,
                  static_smem)


def _shape(rec, name) -> Tuple[int, ...]:
    op = rec.args.get(name)
    return () if op is None else tuple(op.shape)


def _values(rec, name) -> np.ndarray:
    op = rec.args[name]
    if op is None or op.values is None:
        raise ValueError(f"{rec.export}: the contents of {name} were not "
                         "recorded")
    return op.values


# ---------------------------------------------------------------------------
# flash_attention.cu
# ---------------------------------------------------------------------------

def attention_smem(hd: int) -> int:
    """``smem_bytes(hd)``: the float32 attention block."""
    return 4 * (S.ATTN_ROWS * (hd + 1) + S.ATTN_KEYS * (hd + 1)
                + S.ATTN_KEYS * hd + S.ATTN_ROWS * (S.ATTN_KEYS + 1)
                + 2 * S.ATTN_ROWS)


def forward_bf16_smem(hd: int) -> int:
    """``fwd::Plan<HDP>::BYTES``."""
    panels = 1 if hd <= 64 else 2 if hd <= 128 else 4
    tile = FWD_PANEL * panels
    return 1024 + tile + S.FWD_STAGES * 2 * tile + 2 * S.FWD_STAGES * 8


def _hdp(hd: int) -> int:
    return 64 if hd <= 64 else 128


def score_smem(hd: int, g: int, stages: int, fmt: int) -> int:
    """``dec::score_smem`` (fmt -1) and ``dec::quant_score_smem``."""
    hdp = _hdp(hd)
    if fmt < 0:
        return stages * S.ATTN_KEYS * hdp * 2 + 4 * g * hdp
    crow = hdp // 2 if fmt == 0 else hdp
    return (S.ATTN_KEYS * hdp * 2 + 4 * g * hdp
            + stages * S.ATTN_KEYS * (crow + 4 * S.DEC_CODE_SCALES) + 64)


def value_smem(g: int, fmt: int) -> int:
    """``dec::value_smem`` (fmt -1) and ``dec::quant_value_smem``."""
    base = (S.DEC_VALUE_STAGES * (S.ATTN_KEYS * S.DEC_SLICE * 2
                                  + 4 * g * S.ATTN_KEYS)
            + 4 * g * (S.DEC_SLICE + 2 + S.DEC_VALUE_STAGES))
    if fmt < 0:
        return base
    crow = S.DEC_SLICE // 2 if fmt == 0 else S.DEC_SLICE
    return (base + S.DEC_VALUE_STAGES * S.ATTN_KEYS
            * (crow + 4 * (S.DEC_SLICE // 8)) + 64)


_FMT_NAMES = {0: "nf4", 1: "int8"}


def _flash_forward(rec) -> List[Launch]:
    a = rec.args
    B, Sq, H, KV, hd, window = (a[k] for k in ("B", "S", "H", "KV", "hd",
                                              "window"))
    if B <= 0 or Sq <= 0:
        return []
    bf16 = a["dtype"] == 1
    grid = (_cdiv(Sq, S.ATTN_ROWS), H, B)
    G = H // KV

    def tiles():
        x, h, b = _blocks(grid)
        tile = x if not bf16 else grid[0] - 1 - x   # longest rows first
        q_lo = tile * S.ATTN_ROWS
        kv_lo = (np.zeros_like(q_lo) if window < 0
                 else np.maximum(0, q_lo - window + 1))
        view = (B, Sq, H, hd)
        kv_view = (B, Sq, KV, hd)
        rows = np.minimum(q_lo + S.ATTN_ROWS, Sq)
        writes = [box("o", view, (b, q_lo, h, 0), (1, S.ATTN_ROWS, 1, hd))]
        reads = [box("q", view, (b, q_lo, h, 0), (1, S.ATTN_ROWS, 1, hd))]
        reads += [box(t, kv_view, (b, kv_lo, h // G, 0),
                      (1, rows - kv_lo, 1, hd)) for t in ("k", "v")]
        return writes, reads, []

    if bf16:
        return [_launch("flash_forward_bf16_kernel", grid, FWD_THREADS,
                        forward_bf16_smem(hd),
                        S.flash_forward_smem_bytes(hd), tiles)]
    return [_launch("flash_forward_kernel", grid, ATTN_THREADS,
                    attention_smem(hd),
                    S.attention_smem_bytes(hd) - CODEBOOK_BYTES, tiles)]


def _one_block_decode(rec, paged: bool) -> List[Launch]:
    """The float32 decodes: one block of 256 threads per (KV head, slot)
    walks the slot's keys (``attend_block``)."""
    a = rec.args
    B, H, KV, hd = a["B"], a["H"], a["KV"], a["hd"]
    if B <= 0:
        return []
    G = H // KV
    grid = (KV, B)
    lens = _values(rec, "lens")

    def tiles():
        kvh, b, _ = _blocks(grid + (1,))
        writes = [box("o", (B, H, hd), (b, kvh * G, 0), (1, G, hd))]
        if not paged:
            s_max = a["S_max"]
            s_kv = np.minimum(lens[b], s_max)
            reads = [box(t, (B, s_max, KV, hd), (b, 0, kvh, 0),
                         (1, s_kv, 1, hd)) for t in ("kc", "vc")]
            return writes, reads, []
        return writes, [], _page_gathers(rec, a["n_b"] * a["bs"])

    if paged:
        return [_launch("paged_decode_kernel", grid, ATTN_THREADS,
                        attention_smem(hd), S.attention_smem_bytes(hd),
                        tiles, static_smem=CODEBOOK_BYTES)]
    return [_launch("flash_decode_kernel", grid, ATTN_THREADS,
                    attention_smem(hd),
                    S.attention_smem_bytes(hd) - CODEBOOK_BYTES, tiles)]


def _page_gathers(rec, extent: int) -> List[Gather]:
    """The pool rows a paged decode reads: slot ``b``'s table entries for
    its positions below ``min(len, extent)``."""
    a = rec.args
    tables, lens = _values(rec, "tables"), _values(rec, "lens")
    bs, n_b = a["bs"], a["n_b"]
    pool = "k" if "k" in a else "kq"
    n_blocks = _shape(rec, pool)[0]
    used = np.minimum(np.ceil(np.minimum(lens, extent) / bs), n_b)
    ids = [tables[b, :int(n)] for b, n in enumerate(used)]
    ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    return [Gather("page", ids, n_blocks)]


def _split_decode(rec, fmt: int, paged: bool) -> List[Launch]:
    """The bf16 split decode: the score pass, grid (splits, KV, B), each
    block a chunk of ``chunk_tiles`` 64-key tiles; the value pass, grid
    (head-dim slices, KV, B)."""
    a = rec.args
    B, H, KV, hd = a["B"], a["H"], a["KV"], a["hd"]
    if B <= 0:
        return []
    extent = a["extent"] if "extent" in a else a["n_b"] * a["bs"]
    G = H // KV
    chunk = a["chunk_tiles"] * S.ATTN_KEYS
    stages = a["stages"]
    s_grid = (a["splits"], KV, B)
    v_grid = (_cdiv(hd, S.DEC_SLICE), KV, B)
    fname = _FMT_NAMES.get(fmt)
    lens = _values(rec, "lens")
    gathers = _page_gathers(rec, extent) if paged else []
    kt = "k" if fmt < 0 else "kq"

    def score_tiles():
        c, kvh, b = _blocks(s_grid)
        lo = c * chunk
        writes = [box("scores", (B, H, extent), (b, kvh * G, lo),
                      (1, G, chunk))]
        if paged:
            return writes, [], gathers
        reads = [box(kt, (B, extent, KV, hd), (b, lo, kvh, 0),
                     (1, chunk, 1, hd))]
        return writes, reads, []

    def value_tiles():
        d, kvh, b = _blocks(v_grid)
        writes = [box("o", (B, H, hd), (b, kvh * G, d * S.DEC_SLICE),
                      (1, G, S.DEC_SLICE))]
        s_kv = np.minimum(lens[b], extent)
        reads = [box("scores", (B, H, extent), (b, kvh * G, 0),
                     (1, G, s_kv))]
        return writes, reads, gathers

    if fmt < 0:
        names = (("dense_score_pass", "dense_value_pass") if not paged
                 else ("paged_score_pass", "paged_value_pass"))
        budgets = (S.decode_score_smem_bytes(hd, G, stages),
                   S.decode_value_smem_bytes(G))
    else:
        names = ("quant_score_pass", "quant_value_pass")
        budgets = (S.decode_quant_score_smem_bytes(hd, G, stages, fname),
                   S.decode_quant_value_smem_bytes(G, fname))
    return [
        _launch(names[0], s_grid, DEC_THREADS, score_smem(hd, G, stages, fmt),
                budgets[0], score_tiles),
        _launch(names[1], v_grid, DEC_THREADS, value_smem(G, fmt),
                budgets[1], value_tiles),
    ]


# ---------------------------------------------------------------------------
# quanta_apply.cu
# ---------------------------------------------------------------------------

def _chain_tiles(rec, rows: int, rpb: int, d_in: int, d_out: int, grid):
    def tiles():
        x, _, _ = _blocks(grid)
        r0 = x * rpb
        return ([box("out", (rows, d_out), (r0, 0), (rpb, d_out))],
                [box("x", (rows, d_in), (r0, 0), (rpb, d_in))], [])
    return tiles


def _quanta_apply(rec) -> List[Launch]:
    """The float32 chain: the parameters ``f32_params`` reads from meta,
    a block per ``rows_per_block`` rows."""
    a = rec.args
    meta, rows, rpb = list(a["meta"]), a["rows"], a["rows_per_block"]
    if rows <= 0:
        return []
    n_axes, n_stages = meta[0], meta[1]
    cur = list(meta[2:2 + n_axes])
    d_in = d_max = math.prod(cur)
    t_floats = a_row = max_cols = 0
    sp = 2 + n_axes
    for s in range(n_stages):
        m, n, om, on, im, in_ = meta[sp + 6 * s: sp + 6 * s + 6]
        t_floats = max(t_floats, im * in_ * (om * on + 1))
        a_row = max(a_row, in_ * (om * on + 1))
        max_cols = max(max_cols, math.prod(cur) // (im * in_))
        cur[m], cur[n] = om, on
        d_max = max(d_max, math.prod(cur))
    d_out = math.prod(cur)
    t_floats = min(meta[sp + 6 * n_stages], t_floats)
    smem = (t_floats + 2 * max_cols) * 4 + 2 * rpb * d_max * 4
    grid = (_cdiv(rows, rpb),)
    return [_launch("quanta_chain_kernel", grid, CHAIN_F32_THREADS, smem,
                    S.chain_smem_bytes(rpb, d_max, t_floats + 2 * max_cols, 4),
                    _chain_tiles(rec, rows, rpb, d_in, d_out, grid + (1, 1)))]


def _quanta_chain_bf16(rec) -> List[Launch]:
    """The bf16 chain: the plan's header (``bfc::unpack``), a block per
    ``rows_per_block`` rows."""
    a = rec.args
    plan, rows = list(a["plan"]), a["rows"]
    if rows <= 0:
        return []
    d_in, d_out, ld, rpb = plan[2], plan[3], plan[4], plan[5]
    t_elems, tab_ints = plan[8], plan[9]

    def align16(n):
        return _cdiv(n, 16) * 16

    smem = align16(4 * tab_ints) + align16(2 * t_elems) + 4 * rpb * ld
    grid = (_cdiv(rows, rpb),)
    return [_launch("chain_bf16_kernel", grid, S.CHAIN_THREADS, smem,
                    a["smem_bytes"],
                    _chain_tiles(rec, rows, rpb, d_in, d_out, grid + (1, 1)))]


# ---------------------------------------------------------------------------
# The GEMM bodies shared through wgmma_gemm.cuh and tiled_gemm.cuh
# ---------------------------------------------------------------------------

def gemm_smem(bn: int) -> int:
    """``wg::GemmPlan<BN>::BYTES``."""
    stage = GEMM_BM * 128 + 64 * 128 * (bn // 64)
    return 1024 + GEMM_STAGES * stage + 2 * GEMM_STAGES * 8


def wg_decode_smem(rows: int) -> int:
    """``wg::DecPlan<RN>::BYTES`` (RN 8 or 64)."""
    rn = 8 if rows <= 8 else 64
    return (1024 + WG_DEC_STAGES * (64 * 128 + _cdiv(rn * 128, 1024) * 1024)
            + 2 * WG_DEC_STAGES * 8)


def _tile_writes(out: str, view, bm: int, bn: int, grid, split=None):
    """Output tiles of a 2-D tiled body, block (x, y[, z]) at rows y*bm and
    columns x*bn; with ``split`` the tiles of ``(splits, M, N)``
    partials."""
    x, y, z = _blocks(grid)
    if split is None:
        return box(out, view, (y * bm, x * bn), (bm, bn))
    return box(split, (grid[2],) + tuple(view), (z, y * bm, x * bn),
               (1, bm, bn))


def _quanta_linear(rec) -> List[Launch]:
    a = rec.args
    M, N, K, variant = a["M"], a["N"], a["K"], a["variant"]
    ldd, dcol = a["ldd"], a["dcol"]
    if M <= 0 or N <= 0:
        return []

    def delta_tiles(grid, bm, bn):
        """The delta columns each output tile reads: ``[dcol, dcol + N)``
        of rows of ``ldd``."""
        x, y, _ = _blocks(grid)
        return box("delta", (M, ldd), (y * bm, dcol + x * bn),
                   (bm, np.minimum(bn, N - x * bn)))

    if a["dtype"] == 0 and variant == 2:
        grid = (_cdiv(N, SIMT), _cdiv(M, SIMT), 1)

        def tiles():
            _, y, _ = _blocks(grid)
            return ([_tile_writes("out", (M, N), SIMT, SIMT, grid)],
                    [box("x", (M, K), (y * SIMT, 0), (SIMT, K)),
                     delta_tiles(grid, SIMT, SIMT)], [])
        return [_launch("gemm_f32_kernel", grid, SIMT_THREADS, 0,
                        S.qmm_smem_bytes(S.QMM_F32, M), tiles)]
    if variant == 0:
        grid = (_cdiv(N, LINEAR_BN), _cdiv(M, GEMM_BM), 1)

        def tiles():
            _, y, _ = _blocks(grid)
            return ([_tile_writes("out", (M, N), GEMM_BM, LINEAR_BN, grid)],
                    [box("x", (M, K), (y * GEMM_BM, 0), (GEMM_BM, K)),
                     delta_tiles(grid, GEMM_BM, LINEAR_BN)], [])
        return [_launch("ql_wgmma_kernel", grid, GEMM_THREADS,
                        gemm_smem(LINEAR_BN),
                        S.banked_smem_bytes(S.BANKED_PREFILL, M), tiles)]
    splits = a["splits"]
    per = _cdiv(_cdiv(K, 64), splits) * 64
    grid = (_cdiv(N, WG_DEC_BN), splits, 1)

    def part_tiles():
        x, z, _ = _blocks(grid)
        return ([box("part", (splits, M, N), (z, 0, x * WG_DEC_BN),
                     (1, M, WG_DEC_BN))],
                [box("x", (M, K), (0, z * per), (M, per)),
                 box("w", (K, N), (z * per, x * WG_DEC_BN),
                     (per, WG_DEC_BN))], [])

    s_grid = (_cdiv(M * N, ELEMENTWISE), 1, 1)

    def sum_tiles():
        e, _, _ = _blocks(s_grid)
        return ([box("out", (M * N,), (e * ELEMENTWISE,), (ELEMENTWISE,))],
                [box("delta", (M, ldd), (0, dcol), (M, N))], [])
    return [
        _launch("ql_partials_kernel", grid, WG_DEC_THREADS,
                wg_decode_smem(M), S.banked_smem_bytes(S.BANKED_DECODE, M),
                part_tiles),
        _launch("ql_sum_kernel", s_grid, ELEMENTWISE, 0, 0, sum_tiles),
    ]


# ---------------------------------------------------------------------------
# quantized_matmul.cu
# ---------------------------------------------------------------------------

def qmm_stage(rows: int, cols: int, code_rows: int) -> int:
    """``Stage<BM, BN, CR>::BYTES``."""
    raw = (rows * 128 + code_rows * cols + S.QMM_MAX_SCALE_ROWS * cols * 4
           + S.QMM_BK * 4)
    return _cdiv(raw, 1024) * 1024


def qmm_prefill_smem(fmt: int) -> int:
    """``Pre<FMT>::BYTES``."""
    stages = S.QMM_PREFILL_STAGES[_FMT_NAMES[fmt]]
    code_rows = S.QMM_BK // 2 if fmt == 0 else S.QMM_BK
    return (1024 + stages * qmm_stage(QMM_PRE_BM, QMM_PRE_BN, code_rows)
            + 2 * stages * 8)


def qmm_decode_smem(rows: int) -> int:
    """``DecPlan<RN>::BYTES`` of the quantized matmul (RN 8 or 64)."""
    rn = 8 if rows <= 8 else 64
    return (1024 + QMM_DEC_STAGES * qmm_stage(rn, QMM_DEC_BN, S.QMM_BK)
            + 2 * QMM_DEC_STAGES * 8)


def _quantized_matmul(rec) -> List[Launch]:
    a = rec.args
    M, N, K, bs, fmt = a["M"], a["N"], a["K"], a["bs"], a["fmt"]
    variant, dtype = a["variant"], a["dtype"]
    if M <= 0 or N <= 0:
        return []
    steps = _cdiv(K, S.QMM_BK)
    per_steps = _cdiv(steps, a["splits"])
    splits = _cdiv(steps, per_steps)
    per = per_steps * S.QMM_BK
    if dtype == 1 and variant == S.QMM_PREFILL:
        kernel, (bm, bn), threads = ("qmm_prefill_kernel",
                                     (QMM_PRE_BM, QMM_PRE_BN),
                                     QMM_PRE_THREADS)
        smem = qmm_prefill_smem(fmt)
        grid = (_cdiv(N, bn), _cdiv(M, bm), splits)
    elif dtype == 1 and variant == S.QMM_DECODE:
        kernel, threads = "qmm_decode_kernel", QMM_DEC_THREADS
        bm, bn = M, QMM_DEC_BN
        smem = qmm_decode_smem(M)
        grid = (_cdiv(N, bn), 1, splits)
    else:
        kernel, (bm, bn), threads = "qmm_f32_kernel", (SIMT, SIMT), \
            QMM_F32_THREADS
        smem = 0
        grid = (_cdiv(N, bn), _cdiv(M, bm), splits)
    code_div = 2 if fmt == 0 else 1

    def tiles():
        x, y, z = _blocks(grid)
        k0 = z * per
        w = _tile_writes("out", (M, N), bm, bn, grid,
                         split="partial" if splits > 1 else None)
        reads = [
            box("x", (M, K), (y * bm, k0), (bm, per)),
            box("packed", (K // code_div, N), (k0 // code_div, x * bn),
                (per // code_div, bn)),
            box("scales", (_cdiv(K, bs), N), (k0 // bs, x * bn),
                (_cdiv(per, bs) + 1, bn)),
        ]
        return [w], reads, []

    out = [_launch(kernel, grid, threads, smem,
                   S.qmm_smem_bytes(variant, M, _FMT_NAMES.get(fmt, "nf4")),
                   tiles)]
    if splits > 1:
        chunks = _cdiv(M * N, ELEMENTWISE)
        r_grid = (min(chunks, QMM_REDUCE_CAP), 1, 1)

        def reduce_tiles():
            # a grid-stride loop: chunk c of 256 elements falls to block
            # c % blocks; the tiles are the chunks
            c = np.arange(chunks, dtype=np.int64)
            return ([box("out", (M * N,), (c * ELEMENTWISE,),
                         (ELEMENTWISE,))], [], [])
        out.append(_launch("reduce_splits_kernel", r_grid, ELEMENTWISE, 0, 0,
                           reduce_tiles))
    return out


# ---------------------------------------------------------------------------
# banked_gather.cu
# ---------------------------------------------------------------------------

def _banked(rec) -> List[Launch]:
    a = rec.args
    n_slots, Sq, d_in, d_out, r = (a[k] for k in ("n_slots", "S", "d_in",
                                                  "d_out", "r"))
    if n_slots <= 0 or Sq <= 0 or d_out <= 0:
        return []
    M = n_slots * Sq
    splits, k_split = a["splits"], a["k_split"]
    has_w = a["w"] is not None
    bf16_base = has_w and a["x_dtype"] == 1
    ids = _values(rec, "ids")
    n_bank = a["n_bank"]
    out: List[Launch] = []

    s_grid = (_cdiv(Sq, SHRINK_ROWS), n_slots, splits)

    def shrink_tiles():
        x, slot, z = _blocks(s_grid)
        row = slot * Sq + x * SHRINK_ROWS
        size = np.minimum(SHRINK_ROWS, Sq - x * SHRINK_ROWS)
        if splits == 1:
            w = box("za", (M, r), (row, 0), (size, r))
        else:
            w = box("zpart", (splits, M, r), (z, row, 0), (1, size, r))
        reads = [box("x", (n_slots, Sq, d_in),
                     (slot, x * SHRINK_ROWS, z * k_split),
                     (1, SHRINK_ROWS, k_split))]
        return [w], reads, [Gather("bank row", ids[:n_slots], n_bank)]

    out.append(_launch("shrink_kernel", s_grid, ELEMENTWISE, 0, 0,
                       shrink_tiles))
    if splits > 1 and not bf16_base:
        r_grid = (_cdiv(M * r, ELEMENTWISE), 1, 1)

        def reduce_tiles():
            e, _, _ = _blocks(r_grid)
            return ([box("za", (M * r,), (e * ELEMENTWISE,),
                         (ELEMENTWISE,))], [], [])
        out.append(_launch("reduce_kernel", r_grid, ELEMENTWISE, 0, 0,
                           reduce_tiles))

    def row_tiles(grid, row_axis):
        def tiles():
            x, y, _ = _blocks(grid)
            row, col = (x, y) if row_axis == 0 else (y, x)
            return ([box("out", (M, d_out), (row, col * ELEMENTWISE),
                         (1, ELEMENTWISE))], [],
                    [Gather("bank row", ids[:n_slots], n_bank)])
        return tiles

    if not has_w:
        grid = (M, _cdiv(d_out, ELEMENTWISE), 1)
        out.append(_launch("delta_kernel", grid, ELEMENTWISE, 0, 0,
                           row_tiles(grid, 0)))
    elif not bf16_base:
        grid = (_cdiv(d_out, SIMT), _cdiv(M, SIMT), 1)

        def tiles():
            return [_tile_writes("out", (M, d_out), SIMT, SIMT, grid)], [], []
        out.append(_launch("fused_f32_kernel", grid, SIMT_THREADS, 0,
                           S.banked_smem_bytes(S.BANKED_F32, M), tiles))
    elif a["variant"] == S.BANKED_PREFILL:
        bn = S.BANKED_TILES[S.BANKED_PREFILL][1]
        grid = (_cdiv(d_out, bn), _cdiv(M, GEMM_BM), 1)

        def tiles():
            _, y, _ = _blocks(grid)
            return ([_tile_writes("out", (M, d_out), GEMM_BM, bn, grid)],
                    [box("x", (M, d_in), (y * GEMM_BM, 0),
                         (GEMM_BM, d_in))], [])
        out.append(_launch("fused_wgmma_kernel", grid, GEMM_THREADS,
                           gemm_smem(bn),
                           S.banked_smem_bytes(S.BANKED_PREFILL, M), tiles))
    else:
        gsplits = a["gsplits"]
        per = _cdiv(_cdiv(d_in, 64), gsplits) * 64
        grid = (_cdiv(d_out, WG_DEC_BN), gsplits, 1)

        def tiles():
            x, z, _ = _blocks(grid)
            return ([box("gpart", (gsplits, M, d_out),
                         (z, 0, x * WG_DEC_BN), (1, M, WG_DEC_BN))],
                    [box("x", (M, d_in), (0, z * per), (M, per))], [])
        out.append(_launch("decode_gemm_kernel", grid, WG_DEC_THREADS,
                           wg_decode_smem(M),
                           S.banked_smem_bytes(S.BANKED_DECODE, M), tiles))
        c_grid = (_cdiv(d_out, ELEMENTWISE), M, 1)
        out.append(_launch("combine_kernel", c_grid, ELEMENTWISE, 0, 0,
                           row_tiles(c_grid, 1)))
    return out


MODELS: Dict[str, Callable] = {
    "flash_forward_launch": _flash_forward,
    "flash_decode_launch": lambda rec: _one_block_decode(rec, False),
    "paged_decode_launch": lambda rec: _one_block_decode(rec, True),
    "split_decode_launch":
        lambda rec: _split_decode(rec, -1, rec.args["tables"] is not None),
    "quant_split_decode_launch":
        lambda rec: _split_decode(rec, rec.args["fmt"], True),
    "quanta_apply_launch": _quanta_apply,
    "quanta_chain_bf16_launch": _quanta_chain_bf16,
    "quanta_linear_gemm_launch": _quanta_linear,
    "quantized_matmul_launch": _quantized_matmul,
    "banked_lora_launch": _banked,
}


def model(rec) -> List[Launch]:
    """The launches the entry point of ``rec`` makes for its ints."""
    return MODELS[rec.export](rec)
