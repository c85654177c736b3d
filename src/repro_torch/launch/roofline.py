"""Roofline terms of a dry-run cell on the H100 (port of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh) cell, in seconds a step:

    compute    = max over dtypes of FLOPs(dtype) / peak(dtype)
    memory     = bytes accessed / HBM bandwidth
    collective = collective bytes / NVLink bandwidth

every one per device.  The counts come from ``launch/op_cost.py`` (the
aten ops of the port's step run on the ``meta`` device), not from HLO:
FLOPs by dtype, bytes as operands plus results, and the result bytes of
each collective under the JAX package's five kind names.  FLOPs of
different dtypes run on different units (bf16 on the tensor cores,
float32 on the CUDA cores), which may overlap, so the slowest unit's time
is the compute term, as ``chip_smoke.py``'s ``bound`` takes it; a float32
program is billed at the float32 peak, not at the bf16 one.

``model_flops`` (6ND train / 2ND inference plus the attention-context
term) and the four analytic adjustments are the JAX package's arithmetic
on ``ModelConfig``/``ShapeConfig``, unchanged, except that the attention
adjustment bills by default the tiles the port's kernels skip (kernel 3's
64-row query blocks and the 64-key tiles of kernels 3-5, ``kernels/
smem.py``); given the config's ``q_block``/``kv_block`` it is the JAX
package's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from repro_torch.kernels import smem
from repro_torch.models.common import ModelConfig, ShapeConfig
from repro_torch.models.transformer import padded_vocab

__all__ = [
    "HW",
    "COLLECTIVES",
    "peak_flops",
    "compute_seconds",
    "parse_collective_bytes",
    "roofline_terms",
    "model_flops",
    "active_param_count",
    "attention_backend_adjustment",
    "paged_cache_adjustment",
    "quantized_base_adjustment",
    "quantized_kv_adjustment",
    "visible_block_fraction",
    "decode_visible_blocks",
]

# NVIDIA H100 80GB HBM3, 700 W power limit, data-sheet peaks (SXM part,
# dense rates), not measured
HW = dict(
    peak_flops=989e12,        # bf16 (and fp16) on the tensor cores
    peak_flops_f32=67e12,     # float32 on the CUDA cores, TF32 off
    hbm_bw=3.35e12,           # bytes/s, HBM3
    link_bw=450e9,            # bytes/s, NVLink 4 one way (18 links)
    hbm_bytes=80 * 2 ** 30,   # device memory
)

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def peak_flops(dtype) -> float:
    """The card's peak rate for operations in ``dtype`` (a torch dtype or
    its name, ``"torch.bfloat16"``); raises for a dtype without one."""
    name = str(dtype)
    if name in ("torch.bfloat16", "torch.float16"):
        return HW["peak_flops"]
    if name == "torch.float32":
        return HW["peak_flops_f32"]
    raise ValueError(f"no peak rate for operations in {name}")


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """The slowest unit's time: each dtype's FLOPs over its peak."""
    return max((f / peak_flops(dt) for dt, f in flops_by_dtype.items()),
               default=0.0)


def parse_collective_bytes(counts: Dict[str, float]) -> Dict[str, int]:
    """Per-device bytes by collective kind.  The JAX package parses them
    from post-SPMD HLO text; here they are the op counter's (``op_cost``
    ``collectives``), each of the five kinds present."""
    unknown = set(counts) - set(COLLECTIVES)
    if unknown:
        raise ValueError(f"unknown collective kinds {sorted(unknown)}")
    return {k: int(counts.get(k, 0)) for k in COLLECTIVES}


def visible_block_fraction(s: int, block_q: int, block_k: int,
                           window: Optional[int] = None) -> float:
    """Fraction of the ``n_q x n_k`` KV-block grid a causal (windowed)
    flash forward computes: the exact FLOPs ratio flash / reference of
    one forward pass (``repro/kernels/flash_attention.py``'s, and kernel
    3's ``[j_lo, j_hi]`` walk at its 64 x 64 tiles)."""
    bq = min(block_q, s)
    bk = min(block_k, s)
    n_q = -(-s // bq)
    n_k = -(-s // bk)
    visible = 0
    for i in range(n_q):
        q_lo = i * bq
        j_hi = min((q_lo + bq - 1) // bk, n_k - 1)
        j_lo = 0 if window is None else max(0, (q_lo - window + 1) // bk)
        visible += max(0, j_hi - j_lo + 1)
    return visible / float(n_q * n_k)


def decode_visible_blocks(s_max: int, block_k: int,
                          window: Optional[int] = None) -> int:
    """Upper bound on the KV blocks one decode step computes (the whole
    cache when dense; the window's span plus one boundary block when
    windowed)."""
    bk = min(block_k, s_max)
    n_k = -(-s_max // bk)
    if window is None:
        return n_k
    return min(n_k, -(-window // bk) + 1)


def active_param_count(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic parameter counts (total and active per token)."""
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    vpad = padded_vocab(cfg.vocab_size)
    embed = vpad * d * (1 if cfg.tie_embeddings else 2)
    if cfg.frontend == "audio_tokens":
        embed = vpad * d  # LM head only; the frontend is a stub

    if cfg.family == "ssm":
        di = cfg.ssm_expand * d
        h = di // cfg.ssm_head_dim
        per_layer = (
            d * di * 2                       # z, x proj
            + d * (2 * cfg.ssm_state)        # B, C proj
            + d * h + h * 3                  # dt proj + dt_bias/a/d
            + cfg.conv_kernel * (di + 2 * cfg.ssm_state)
            + di * d + di + d                # out_proj + norms
        )
        total = nl * per_layer + embed
        return {"total": total, "active": total}

    if cfg.family == "hybrid":
        dr = cfg.lru_width or d
        rec = d * dr * 2 + cfg.conv_kernel * dr + 2 * dr * dr + dr + dr * d
        mlp = 3 * d * ff
        attn = d * cfg.attn_dim + 2 * d * cfg.kv_dim + cfg.attn_dim * d
        n_macro = nl // cfg.attn_period
        n_tail = nl - n_macro * cfg.attn_period
        total = (
            n_macro * (2 * rec + attn + 3 * mlp)
            + n_tail * (rec + mlp)
            + embed
        )
        return {"total": total, "active": total}

    attn = d * cfg.attn_dim + 2 * d * cfg.kv_dim + cfg.attn_dim * d
    if cfg.is_moe:
        expert = 3 * d * ff
        router = d * cfg.n_experts
        total = nl * (attn + router + cfg.n_experts * expert) + embed
        active = nl * (attn + router + cfg.top_k * expert) + embed
        return {"total": total, "active": active}
    total = nl * (attn + 3 * d * ff) + embed
    return {"total": total, "active": total}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful model FLOPs a step (6ND train / 2ND inference plus the
    attention-context term)."""
    counts = active_param_count(cfg)
    vpad = padded_vocab(cfg.vocab_size)
    n_active_body = counts["active"] - vpad * cfg.d_model * (
        1 if cfg.tie_embeddings or cfg.frontend == "audio_tokens" else 2
    )
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        tokens = b  # one token a sequence
        mult = 2.0
        s_kv = min(s, cfg.local_window) if cfg.family == "hybrid" else s
    else:
        tokens = b * s
        mult = 6.0 if shape.kind == "train" else 2.0
        s_kv = s / 2  # causal average context
        if cfg.sliding_window:
            s_kv = min(s_kv, cfg.sliding_window)
        if cfg.family == "hybrid":
            s_kv = min(s_kv, cfg.local_window)

    body = mult * n_active_body * tokens
    head = mult * cfg.d_model * vpad * (
        tokens if shape.kind == "train" else b
    )
    # attention context: 2*H*hd*s_kv (QK^T) + 2*H*hd*s_kv (PV) a token
    if cfg.family == "ssm":
        attn_ctx = 0.0
    else:
        n_attn_layers = (
            cfg.n_layers // cfg.attn_period if cfg.family == "hybrid"
            else cfg.n_layers
        )
        attn_ctx = (
            mult / 2 * 4 * cfg.n_heads * cfg.head_dim * s_kv
            * tokens * n_attn_layers
        )
    return body + head + attn_ctx


def attention_backend_adjustment(
    cfg: ModelConfig, shape: ShapeConfig, q_block: Optional[int] = None,
    kv_block: Optional[int] = None,
) -> Optional[Dict[str, float]]:
    """Analytic attention-term swap for ``cfg.attn_backend == "pallas"``
    (the hand-written flash kernels 3-5).

    A kernel launch is opaque to the op counter (a ``ctypes`` call, no
    aten op), so the dry run runs the reference program and this
    function swaps the attention terms: masked KV tiles the kernel skips
    stop being billed as compute, and the score/probs tensors (in shared
    memory in the kernel) stop being billed as HBM traffic.

    Per attention layer and forward pass:

    * reference FLOPs: ``4 * H * hd`` per (q, kv) pair over all ``S^2``
      pairs (the reference computes whole rows and masks),
    * flash FLOPs: the same rate over the visible tiles' pairs
      (:func:`visible_block_fraction` at ``q_block`` x ``kv_block``:
      kernel 3's 64-row blocks and 64-key tiles unless given; the
      config's ``q_block``/``kv_block`` give the JAX package's figure),
    * score traffic saved: fp32 scores + probs written and read per pair
      (probs at bf16 under ``fast_softmax``); the q/k/v/out reads are
      common to both backends and cancel.

    Training swaps the two forward instances (loss + remat) and bills
    the custom backward's recompute (kernel 3's ``autograd.Function``
    recomputes one banded forward: ``banded_recompute``) at the visible
    fraction, with its banded score traffic; the banded backward's own
    savings are not billed.  Returns ``None`` when the backend is
    "reference", the family has no attention layers, or (hybrid decode)
    the model never routes through a kernel.
    """
    if cfg.attn_backend != "pallas" or cfg.family == "ssm":
        return None
    q_block = smem.FWD_ROWS if q_block is None else q_block
    kv_block = smem.ATTN_KEYS if kv_block is None else kv_block
    b, s = shape.global_batch, shape.seq_len
    h, hd = cfg.n_heads, cfg.head_dim
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_period
        window = cfg.local_window
    else:
        n_attn = cfg.n_layers
        window = cfg.sliding_window

    if shape.kind == "decode":
        if cfg.family == "hybrid":
            # Griffin decodes its local_window ring in plain PyTorch and
            # never routes through a decode kernel: nothing to swap
            return None
        fwd_passes = 1
        bk = min(kv_block, s)
        ref_pairs = float(b * s)            # 1 query row over the cache
        flash_pairs = float(
            b * min(s, decode_visible_blocks(s, kv_block, window) * bk)
        )
        visible_fraction = flash_pairs / ref_pairs
    else:
        fwd_passes = 2 if shape.kind == "train" else 1
        bq = min(q_block, s)
        bk = min(kv_block, s)
        n_q, n_k = -(-s // bq), -(-s // bk)
        visible_fraction = visible_block_fraction(s, q_block, kv_block,
                                                  window)
        ref_pairs = float(b * s * s)
        flash_pairs = float(b) * visible_fraction * (n_q * bq) * (n_k * bk)

    per_pair_flops = 4.0 * h * hd           # QK^T + PV, per head row
    ref_flops = fwd_passes * n_attn * per_pair_flops * ref_pairs
    flash_flops = fwd_passes * n_attn * per_pair_flops * flash_pairs
    probs_bytes = 2 if cfg.fast_softmax else 4
    score_instance = n_attn * float(h) * ref_pairs * 2.0 * (4 + probs_bytes)
    if shape.kind == "train":
        # the custom backward recomputes one banded forward the reference
        # autograd does not: bill its FLOPs and its banded score traffic
        recompute_flops = n_attn * per_pair_flops * flash_pairs
        bytes_saved = (fwd_passes - visible_fraction) * score_instance
    else:
        recompute_flops = 0.0
        bytes_saved = fwd_passes * score_instance
    return {
        "visible_block_fraction": visible_fraction,
        "fwd_passes": fwd_passes,
        "ref_attn_flops": ref_flops,
        "flash_attn_flops": flash_flops,
        "recompute_flops_billed": recompute_flops,
        "flops_saved": ref_flops - flash_flops - recompute_flops,
        "score_bytes_saved": bytes_saved,
    }


def _paged_rows(cfg: ModelConfig, s: int) -> int:
    # ceil the fractional token before ceiling to whole blocks
    # (partially filled blocks are fetched whole)
    bs = cfg.kv_block_size
    return min(s, -(-math.ceil(cfg.kv_occupancy * s) // bs) * bs)


def paged_cache_adjustment(
    cfg: ModelConfig, shape: ShapeConfig
) -> Optional[Dict[str, float]]:
    """Analytic decode-memory swap for ``cfg.kv_cache == "paged"``.

    The dense cache makes every decode step read ``seq_len`` KV rows a
    slot; the paged decode (kernel 5 over the block tables) reads only
    each slot's allocated blocks.  The dry run runs the dense program, so
    the KV reads are rebilled: ``kv_occupancy * seq_len`` rows a slot,
    rounded up to whole blocks.  Only the attention reads of the k/v
    leaves are swapped (conservative).  Not divided by chips: a data
    rank decodes its own slots over the whole cache length.  ``None``
    for non-decode shapes, the SSM family and the hybrid one (whose
    window-bounded ring decodes in plain PyTorch).
    """
    if cfg.kv_cache != "paged" or shape.kind != "decode":
        return None
    if cfg.family in ("ssm", "hybrid"):
        return None
    if not 0.0 < cfg.kv_occupancy <= 1.0:
        raise ValueError(f"kv_occupancy {cfg.kv_occupancy} outside (0, 1]")
    b, s = shape.global_batch, shape.seq_len
    dense_rows = s
    paged_rows = _paged_rows(cfg, s)
    row_bytes = 2 * cfg.n_layers * cfg.kv_dim * cfg.param_dtype.itemsize
    return {
        "block_size": cfg.kv_block_size,
        "occupancy": cfg.kv_occupancy,
        "dense_rows_per_slot": float(dense_rows),
        "paged_rows_per_slot": float(paged_rows),
        "kv_read_bytes_dense": float(b * dense_rows * row_bytes),
        "kv_read_bytes_paged": float(b * paged_rows * row_bytes),
        "kv_bytes_saved": float(b * (dense_rows - paged_rows) * row_bytes),
    }


def quantized_base_adjustment(
    cfg: ModelConfig, shape: ShapeConfig
) -> Optional[Dict[str, float]]:
    """Analytic decode weight-stream swap for ``cfg.base_quant``.

    Decode reads the whole frozen base once a step.  With a quantized
    base the fused dequant-matmul (kernel 7) streams the packed codes and
    block scales; the dry run runs the fp program (the counter cannot see
    into a kernel), so the quantizable projections' weight reads are
    rebilled at packed bytes: ``0.5`` (nf4) / ``1.0`` (int8) a parameter
    plus the fp32 block scale ``4 / quant_block_size``.  Counted per
    family as ``core/quantize.py`` ``quantize_params`` targets them
    (dense q/k/v/o + gate/up/down; MoE attention only; SSM z/x/out;
    hybrid recurrent gate/rec/out + attention + MLP per macro block).
    Prefill/train return ``None``: there the weight read is amortized
    over ``S`` tokens.  Divided by chips when applied, as the JAX
    package's (its projections are tensor-parallel).
    """
    if cfg.base_quant is None or shape.kind != "decode":
        return None
    if cfg.base_quant not in ("nf4", "int8"):
        raise ValueError(f"unknown base_quant {cfg.base_quant!r}")
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    attn = d * cfg.attn_dim + 2 * d * cfg.kv_dim + cfg.attn_dim * d
    if cfg.family == "ssm":
        di = cfg.ssm_expand * d
        q_params = nl * (2 * d * di + di * d)          # z_proj, x_proj, out
    elif cfg.family == "hybrid":
        dr = cfg.lru_width or d
        rec_q = 2 * d * dr + dr * d                    # gate, rec, out proj
        mlp_q = 3 * d * ff                             # gate, up, down
        n_macro = nl // cfg.attn_period
        n_tail = nl - n_macro * cfg.attn_period
        q_params = (
            n_macro * (2 * rec_q + attn + 3 * mlp_q)
            + n_tail * (rec_q + mlp_q)
        )
    elif cfg.is_moe:
        q_params = nl * attn                           # experts stay dense
    else:
        q_params = nl * (attn + 3 * d * ff)
    fp_bytes = float(cfg.param_dtype.itemsize)
    scale_bytes = 4.0  # fp32 block scales
    code_bytes = 0.5 if cfg.base_quant == "nf4" else 1.0
    q_bytes = code_bytes + scale_bytes / cfg.quant_block_size
    return {
        "fmt": cfg.base_quant,
        "block_size": cfg.quant_block_size,
        "quantized_params": float(q_params),
        "weight_bytes_fp": float(q_params) * fp_bytes,
        "weight_bytes_quant": float(q_params) * q_bytes,
        "weight_bytes_saved": float(q_params) * (fp_bytes - q_bytes),
        "weight_stream_cut": fp_bytes / q_bytes,
    }


def quantized_kv_adjustment(
    cfg: ModelConfig, shape: ShapeConfig
) -> Optional[Dict[str, float]]:
    """Analytic decode KV-read swap for ``cfg.kv_quant``.

    Quantized KV blocks hold packed codes and fp32 block scales, which
    the paged decode (kernel 6) dequantizes in shared memory.  The dry
    run runs the fp-cache program, so the paged KV reads are rebilled at
    code + scale bytes: ``0.5`` (nf4) / ``1.0`` (int8) an element plus
    ``4 / quant_block_size``.  Rows as :func:`paged_cache_adjustment`'s
    (occupancy ceiled to whole blocks), not divided by chips; only paged
    decode on attention families qualifies.
    """
    if cfg.kv_quant is None:
        return None
    if cfg.kv_quant not in ("nf4", "int8"):
        raise ValueError(f"unknown kv_quant {cfg.kv_quant!r}")
    if cfg.kv_cache != "paged" or shape.kind != "decode":
        return None
    if cfg.family in ("ssm", "hybrid"):
        return None
    if not 0.0 < cfg.kv_occupancy <= 1.0:
        raise ValueError(f"kv_occupancy {cfg.kv_occupancy} outside (0, 1]")
    b, s = shape.global_batch, shape.seq_len
    paged_rows = _paged_rows(cfg, s)
    fp_bytes = float(cfg.param_dtype.itemsize)
    code_bytes = 0.5 if cfg.kv_quant == "nf4" else 1.0
    q_bytes = code_bytes + 4.0 / cfg.quant_block_size  # fp32 block scales
    n_elems = 2 * cfg.n_layers * cfg.kv_dim            # k + v a row
    return {
        "fmt": cfg.kv_quant,
        "block_size": cfg.quant_block_size,
        "paged_rows_per_slot": float(paged_rows),
        "kv_read_bytes_fp": float(b * paged_rows * n_elems) * fp_bytes,
        "kv_read_bytes_quant": float(b * paged_rows * n_elems) * q_bytes,
        "kv_bytes_saved": float(b * paged_rows * n_elems)
        * (fp_bytes - q_bytes),
        "kv_stream_cut": fp_bytes / q_bytes,
    }


def roofline_terms(
    cfg: ModelConfig,
    shape: ShapeConfig,
    n_chips: int,
    cost: Dict[str, Any],
    collective_bytes: Dict[str, int],
    device_shape: Optional[ShapeConfig] = None,
) -> Dict[str, Any]:
    """The roofline record of one cell from its per-device counts.

    ``cost``: ``"flops"`` and ``"bytes accessed"`` a device, and
    ``"flops_by_dtype"`` (``{"torch.bfloat16": f, ...}``; without it every
    FLOP is billed in ``cfg.compute_dtype``).  ``shape`` is the cell's
    (``model_flops`` takes it).  The adjustments' savings become a
    device's in one of two ways:

    * ``device_shape`` given (the port's program): a device runs that
      share of the cell whole, with whole weights (the ``model`` axis is
      replicated), so the savings at ``device_shape`` come off
      undivided, the attention's at the port's kernel tiles;
    * ``None`` (the JAX program's convention): the savings at ``shape``
      divided by ``n_chips`` (tensor-parallel weights), but the paged
      and quantized-KV ones not (JAX's decode program gathers the whole
      cache on every device), the attention's at the config's
      ``q_block``/``kv_block``.

    The keys are the JAX package's, and ``flops_by_dtype``.
    """
    by_dtype = {str(k): float(v) for k, v in (
        cost.get("flops_by_dtype")
        or {str(cfg.compute_dtype): cost.get("flops", 0.0)}).items()}
    hlo_bytes_dev = float(cost.get("bytes accessed", 0.0))
    if device_shape is None:
        # divisors of the savings: sharded over the chips, and the KV
        # reads (gathered whole on every device)
        at, div, tiles = shape, n_chips, (cfg.q_block, cfg.kv_block)
    else:
        at, div, tiles = device_shape, 1, (None, None)
    adj = attention_backend_adjustment(cfg, at, *tiles)
    if adj is not None:
        # the reference attention's products run in the compute dtype:
        # the kernels' skipped tiles come off that unit's FLOPs
        dt = str(cfg.compute_dtype)
        by_dtype[dt] = max(0.0, by_dtype.get(dt, 0.0)
                           - adj["flops_saved"] / div)
        hlo_bytes_dev = max(
            0.0, hlo_bytes_dev - adj["score_bytes_saved"] / div
        )
    padj = paged_cache_adjustment(cfg, at)
    if padj is not None:
        hlo_bytes_dev = max(0.0, hlo_bytes_dev - padj["kv_bytes_saved"])
    qadj = quantized_base_adjustment(cfg, at)
    if qadj is not None:
        hlo_bytes_dev = max(
            0.0, hlo_bytes_dev - qadj["weight_bytes_saved"] / div
        )
    kvadj = quantized_kv_adjustment(cfg, at)
    if kvadj is not None:
        hlo_bytes_dev = max(0.0, hlo_bytes_dev - kvadj["kv_bytes_saved"])
    hlo_flops_dev = sum(by_dtype.values())
    coll_per_device = float(sum(collective_bytes.values()))
    t_compute = compute_seconds(by_dtype)
    t_memory = hlo_bytes_dev / HW["hbm_bw"]
    t_collective = coll_per_device / HW["link_bw"]
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_collective,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_flops_global = hlo_flops_dev * n_chips
    bound_s = max(terms.values())
    return {
        **terms,
        "attn_backend": cfg.attn_backend,
        "attn_adjustment": adj,
        "kv_cache": cfg.kv_cache,
        "paged_adjustment": padj,
        "base_quant": cfg.base_quant,
        "quantized_adjustment": qadj,
        "kv_quant": cfg.kv_quant,
        "quantized_kv_adjustment": kvadj,
        "dominant": dominant.replace("_s", ""),
        "hlo_flops_per_device": hlo_flops_dev,
        "hlo_flops": hlo_flops_global,
        "flops_by_dtype": by_dtype,
        "hlo_bytes_per_device": hlo_bytes_dev,
        "hlo_bytes": hlo_bytes_dev * n_chips,
        "collective_bytes_per_device": coll_per_device,
        "collective_breakdown": collective_bytes,
        "model_flops": mf,
        "useful_flop_ratio": (
            mf / hlo_flops_global if hlo_flops_global else None
        ),
        "step_time_bound_s": bound_s,
        "mfu_bound": (
            mf / (bound_s * n_chips * peak_flops(cfg.compute_dtype))
            if bound_s > 0 else None
        ),
    }
