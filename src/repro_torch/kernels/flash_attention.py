"""Causal flash attention (prefill) and flash decode over a dense cache or
a paged pool (of rows, or of NF4/int8 codes): CUDA kernels in
``csrc/flash_attention.cu`` and their plain PyTorch versions.

Replaces the TPU kernels of ``repro/kernels/flash_attention.py``:
``_flash_forward`` (public ``flash_attention``), ``flash_decode_attention``
and ``paged_flash_decode_attention`` with and without ``kv_quant``.
Layouts are the JAX package's: ``q (B, S, H, hd)``, ``k/v (B, S, KV,
hd)``, a dense cache ``(B, S_max, KV, hd)``, pools ``(n_blocks, bs, KV,
hd)`` (codes ``(.., hd // 2)`` uint8 for NF4, ``(.., hd)`` int8, scales
``(.., ceil(hd / quant_block))`` fp32), block tables ``(B, n_b)`` and
``cache_len (B,)``.  CPU tensors run the plain versions
(:func:`flash_attention_plain`, :func:`flash_decode_attention_plain` and
:func:`paged_decode_attention_plain`), which walk the same 64-key tiles as
the kernels with the same online softmax and the same rounding points
(the paged one gathers the pool through the table, decoded and rounded
to the value dtype, first); CUDA tensors launch the kernels, whose split
decode over bf16 rows or codes keeps the one-block walk's bits.
:func:`blockwise_reference_attention` and
:func:`decode_reference_attention` are the reference backend's
attention, with the softmax normalised before ``p`` is cast.

Training: :func:`flash_attention` runs the forward inside a
``torch.autograd.Function`` whenever autograd needs a gradient through
it.  The Function saves only q, k and v; its backward is the VJP of
:func:`banded_recompute`, a plain-PyTorch blockwise recompute over each
query block's visible KV band (the JAX package's ``_flash_bwd``, itself
pure JAX).  So its gradient is that of the reference attention, which
normalises before it casts, and not of the kernel's own forward, which
casts ``p`` before it normalises.  The decode kernels stay forward only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.quantize import codebook, kv_dequant_values
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (
    MASK_VALUE, aligned16, masked_softmax, route,
)
from repro_torch.kernels.smem import (
    FWD_MAX_HEAD_DIM, attention_smem_bytes, decode_plan, device_limits,
    flash_forward_smem_bytes,
)

__all__ = [
    "flash_attention",
    "banded_recompute",
    "flash_decode_attention",
    "flash_attention_plain",
    "flash_decode_attention_plain",
    "paged_flash_decode_attention",
    "paged_flash_decode_attention_quant",
    "paged_decode_attention_plain",
    "gather_pages",
    "gather_kv",
    "blockwise_reference_attention",
    "decode_reference_attention",
    "pad_to_q_block",
    "KERNEL_BLOCK",
]

# query rows per block and keys per tile of both CUDA kernels
KERNEL_BLOCK = 64
# head_dim limit of the CUDA decodes (kernels 4-6); the forward (kernel 3)
# takes up to FWD_MAX_HEAD_DIM (256, Griffin)
_MAX_HEAD_DIM = 128


def _visible_j_range(q_lo: int, bq: int, bk: int, n_k: int,
                     window: Optional[int]):
    """Inclusive KV-tile range ``[j_lo, j_hi]`` visible to the query tile
    starting at ``q_lo`` (the CUDA forward computes the same range)."""
    j_hi = min((q_lo + bq - 1) // bk, n_k - 1)
    j_lo = 0 if window is None else max(0, (q_lo - window + 1) // bk)
    return j_lo, j_hi


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def pad_to_q_block(s: int, q_block: int) -> tuple:
    """Effective ``(q_block, padded_s)`` for a sequence of length ``s``."""
    bq = min(q_block, s)
    return bq, s + ((-s) % bq)


def _block_attend(
    q: torch.Tensor,          # (B, Bq, KV, G, hd)
    k: torch.Tensor,          # (B, S, KV, hd)
    v: torch.Tensor,          # (B, S, KV, hd)
    q_pos: torch.Tensor,      # (Bq,)
    kv_pos: torch.Tensor,     # (S,)
    window: Optional[int],
    softmax_scale: float,
    fast_softmax: bool,
) -> torch.Tensor:
    scores = torch.einsum(
        "bqkgh,bskh->bkgqs", q.float(), k.float()
    ) * softmax_scale                                   # (B, KV, G, Bq, S)
    causal = q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        causal &= (q_pos[:, None] - kv_pos[None, :]) < window
    scores = torch.where(causal, scores, MASK_VALUE)
    probs = masked_softmax(scores, v.dtype, fast_softmax)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def blockwise_reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_block: int = 512,
    window: Optional[int] = None,
    fast_softmax: bool = False,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain causal attention over query blocks: full score rows are
    computed and masked.  Returns ``(B, S, H, hd)``."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, kv, g, hd)
    kv_pos = torch.arange(s, device=q.device)
    bq, s_pad = pad_to_q_block(s, q_block)
    outs = []
    for lo in range(0, s_pad, bq):
        hi = min(lo + bq, s)
        outs.append(_block_attend(
            qg[:, lo:hi], k, v, kv_pos[lo:hi], kv_pos, window, scale,
            fast_softmax,
        ))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


def decode_reference_attention(
    q: torch.Tensor,              # (B, 1, H, hd)
    k_cache: torch.Tensor,        # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,      # (B,) valid entries (incl. the new token)
    *,
    window: Optional[int] = None,
    fast_softmax: bool = False,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain single-step attention over a dense cache (the reference
    branch of ``models/attention.decode_attention``)."""
    b, _, h, hd = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, 1, kv, g, hd)
    kv_pos = torch.arange(s_max, device=q.device)
    cache_len = cache_len.to(q.device)
    q_pos = cache_len - 1
    scores = torch.einsum(
        "bqkgh,bskh->bkgqs", qg.float(), k_cache.float()
    ) * scale                                           # (B, KV, G, 1, S)
    valid = kv_pos[None, :] < cache_len[:, None]
    if window is not None:
        valid &= (q_pos[:, None] - kv_pos[None, :]) < window
    scores = torch.where(valid[:, None, None, None, :], scores, MASK_VALUE)
    probs = masked_softmax(scores, v_cache.dtype, fast_softmax)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache)
    return out.reshape(b, 1, h, hd)


def _attend_tiles(
    qg: torch.Tensor,         # (B, R, KV, G, hd)
    k: torch.Tensor,          # (B, S, KV, hd)
    v: torch.Tensor,          # (B, S, KV, hd)
    q_pos: torch.Tensor,      # (B, R) position of each query row
    j_lo: torch.Tensor,       # (B,) first KV tile each slot visits
    j_hi: torch.Tensor,       # (B,) last KV tile each slot visits
    window: Optional[int],
    scale: float,
) -> torch.Tensor:
    """The CUDA kernels' ``attend_block`` in plain PyTorch: an online
    softmax over 64-key tiles ``j_lo..j_hi`` (fp32 running max,
    denominator and accumulator), ``p`` cast to v's dtype before PV, the
    output rounded once.  Returns ``(B, R, KV, G, hd)`` in v's dtype."""
    b, r, kvh, g, hd = qg.shape
    s_kv = k.shape[1]
    dev = qg.device
    m = torch.full((b, kvh, g, r), MASK_VALUE, dtype=torch.float32,
                   device=dev)
    denom = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, r, hd), dtype=torch.float32, device=dev)
    qf = qg.float()
    n_tiles = int(j_hi.max()) + 1 if j_hi.numel() else 0
    for j in range(int(j_lo.min()) if j_lo.numel() else 0, n_tiles):
        kv0 = j * KERNEL_BLOCK
        kv1 = min(kv0 + KERNEL_BLOCK, s_kv)
        kv_pos = torch.arange(kv0, kv1, device=dev)
        scores = torch.einsum(
            "brkgh,bskh->bkgrs", qf, k[:, kv0:kv1].float()) * scale
        ok = kv_pos[None, None, :] <= q_pos[:, :, None]          # (B, R, s)
        if window is not None:
            ok &= (q_pos[:, :, None] - kv_pos[None, None, :]) < window
        scores = torch.where(ok[:, None, None], scores, MASK_VALUE)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        pv = torch.einsum("bkgrs,bskh->bkgrh", p.to(v.dtype).float(),
                          v[:, kv0:kv1].float())
        visit = ((j_lo <= j) & (j <= j_hi))[:, None, None, None]
        denom = torch.where(visit, alpha * denom + p.sum(dim=-1), denom)
        acc = torch.where(visit[..., None], acc * alpha[..., None] + pv, acc)
        m = torch.where(visit, m_new, m)
    out = acc / torch.where(denom == 0, 1.0, denom)[..., None]
    return out.to(v.dtype).permute(0, 3, 1, 2, 4)


def flash_attention_plain(
    q: torch.Tensor,               # (B, S, H, hd)
    k: torch.Tensor,               # (B, S, KV, hd)
    v: torch.Tensor,               # (B, S, KV, hd)
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """The flash forward kernel's arithmetic in plain PyTorch: each
    64-row query tile walks the KV tiles of :func:`_visible_j_range`.
    Returns ``(B, S, H, hd)`` in v's dtype."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    n_k = -(-s // KERNEL_BLOCK)
    outs = []
    for q_lo in range(0, s, KERNEL_BLOCK):
        q_hi = min(q_lo + KERNEL_BLOCK, s)
        j_lo, j_hi = _visible_j_range(q_lo, KERNEL_BLOCK, KERNEL_BLOCK, n_k,
                                      window)
        pos = torch.arange(q_lo, q_hi, device=q.device).expand(b, -1)
        outs.append(_attend_tiles(
            qg[:, q_lo:q_hi], k, v, pos,
            torch.full((b,), j_lo, device=q.device),
            torch.full((b,), j_hi, device=q.device), window, scale))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


def flash_decode_attention_plain(
    q: torch.Tensor,               # (B, 1, H, hd)
    k_cache: torch.Tensor,         # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,       # (B,) valid entries (incl. the new token)
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """The flash decode kernel's arithmetic in plain PyTorch: each slot
    walks the KV tiles up to its own ``cache_len`` (and from its window's
    first tile).  Returns ``(B, 1, H, hd)`` in v's dtype."""
    b, _, h, hd = q.shape
    s_max, kvh = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    q_pos = cache_len.to(device=q.device, dtype=torch.long) - 1
    n_k = -(-s_max // KERNEL_BLOCK)
    j_hi = torch.where(q_pos >= 0, torch.clamp(q_pos // KERNEL_BLOCK,
                                               max=n_k - 1), -1)
    j_lo = torch.zeros_like(q_pos)
    if window is not None:
        j_lo = torch.clamp(q_pos - window + 1, min=0) // KERNEL_BLOCK
    out = _attend_tiles(q.reshape(b, 1, kvh, h // kvh, hd), k_cache, v_cache,
                        q_pos[:, None], j_lo, j_hi, window, scale)
    return out.reshape(b, 1, h, hd)


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """The dense ``(B, n_b * bs, ...)`` view of a pool ``(n_blocks, bs,
    ...)`` through per-slot block tables ``(B, n_b)``."""
    b, n_b = block_tables.shape
    g = pool[block_tables.long()]                     # (B, n_b, bs, ...)
    return g.reshape(b, n_b * pool.shape[1], *pool.shape[2:])


def gather_kv(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    kv_quant: Optional[str] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    quant_block: int = 64,
    value_dtype=None,
):
    """Dense ``(B, n_b * bs, KV, hd)`` keys and values of a paged pool;
    under ``kv_quant`` decoded to fp32 and rounded to ``value_dtype``
    (default q's)."""
    k = gather_pages(k_pool, block_tables)
    v = gather_pages(v_pool, block_tables)
    if kv_quant is None:
        return k, v
    hd, dt = q.shape[-1], value_dtype or q.dtype

    def decode(codes, scales):
        return kv_dequant_values(codes, gather_pages(scales, block_tables),
                                 fmt=kv_quant, block_size=quant_block,
                                 d=hd).to(dt)

    return decode(k, k_scales), decode(v, v_scales)


def paged_decode_attention_plain(
    q: torch.Tensor,               # (B, 1, H, hd)
    k_pool: torch.Tensor,          # (n_blocks, bs, KV, hd | hd//2)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,    # (B, n_b) pool rows
    cache_len: torch.Tensor,       # (B,) valid entries (incl. the new token)
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    kv_quant: Optional[str] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    quant_block: int = 64,
    value_dtype=None,
) -> torch.Tensor:
    """The paged decode kernels' arithmetic in plain PyTorch: the pool
    gathered through the table (decoded to fp32 and rounded to
    ``value_dtype``, default q's, under ``kv_quant``), then the dense
    decode's 64-key tile walk.  Returns ``(B, 1, H, hd)``."""
    k, v = gather_kv(q, k_pool, v_pool, block_tables, kv_quant=kv_quant,
                     k_scales=k_scales, v_scales=v_scales,
                     quant_block=quant_block, value_dtype=value_dtype)
    return flash_decode_attention_plain(q, k, v, cache_len, window=window,
                                        softmax_scale=softmax_scale)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _bind(name: str, n_ptrs: int, n_ints: int, n_lead: int = 1):
    """A C entry point taking ``n_lead`` int codes, ``n_ptrs`` pointers,
    ``n_ints`` ints, then the scale, the shared-memory limit and the
    stream."""
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int] * n_lead + [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_int] * n_ints
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    return fn


def _check_heads(h: int, kv: int, hd: int,
                 max_hd: int = _MAX_HEAD_DIM) -> None:
    """Refuse heads a CUDA attention kernel cannot take: head_dim above
    ``max_hd`` (the decodes' 128 by default, the forward's 256) or more
    than 64 query heads over a KV head."""
    if h % kv:
        raise ValueError(f"n_heads {h} must be a multiple of n_kv_heads {kv}")
    if hd > max_hd or h // kv > KERNEL_BLOCK:
        raise ValueError(
            f"this CUDA attention kernel takes head_dim <= {max_hd} and "
            f"at most {KERNEL_BLOCK} query heads per KV head"
        )


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def banded_recompute(
    q: torch.Tensor,               # (B, S, H, hd)
    k: torch.Tensor,               # (B, S, KV, hd)
    v: torch.Tensor,               # (B, S, KV, hd)
    *,
    block_q: int,
    window: Optional[int],
    scale: float,
) -> torch.Tensor:
    """The flash backward's recompute target (the JAX package's
    ``_banded_recompute``): reference attention over query blocks of
    ``block_q`` rows, each block over its visible KV band ``[q_lo - window
    + 1, q_hi]`` only.  Excluded columns have exactly zero probability,
    so the values are those of :func:`blockwise_reference_attention`;
    its VJP is the flash backward.  Returns ``(B, S, H, hd)``."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    bq, s_pad = pad_to_q_block(s, block_q)
    pos = torch.arange(s, device=q.device)
    outs = []
    for q_lo in range(0, s_pad, bq):
        q_hi = min(q_lo + bq, s)
        kv_lo = 0 if window is None else max(0, q_lo - window + 1)
        outs.append(_block_attend(
            qg[:, q_lo:q_hi], k[:, kv_lo:q_hi], v[:, kv_lo:q_hi],
            pos[q_lo:q_hi], pos[kv_lo:q_hi], window, scale, False,
        ))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


class _FlashAttention(torch.autograd.Function):
    """Kernel 3 under autograd: the forward launches the kernel (the plain
    version on the CPU) and saves q, k and v only; the backward is the VJP
    of :func:`banded_recompute`.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass, with nothing kept outside
    ``ctx``."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale, block_q):
        ctx.save_for_backward(q, k, v)
        ctx.spec = (window, scale, block_q)
        return _flash_forward(q, k, v, window, scale)

    @staticmethod
    def backward(ctx, g):
        window, scale, block_q = ctx.spec
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            out = banded_recompute(q, k, v, block_q=block_q, window=window,
                                   scale=scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,               # (B, S, H, hd)
    k: torch.Tensor,               # (B, S, KV, hd)
    v: torch.Tensor,               # (B, S, KV, hd)
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    block_q: int = 512,
) -> torch.Tensor:
    """Causal (optionally sliding-window) flash attention.  Returns ``(B,
    S, H, hd)``.  When autograd needs a gradient through it (grad mode on
    and q, k or v requiring grad) it runs as :class:`_FlashAttention`,
    whose backward recomputes over query blocks of ``block_q`` rows (the
    model's ``q_block``); otherwise the forward alone."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError(f"n_heads {h} must be a multiple of n_kv_heads {kv}")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, window, scale, block_q)
    return _flash_forward(q, k, v, window, scale)


def _flash_forward(q, k, v, window: Optional[int], scale: float
                   ) -> torch.Tensor:
    """Kernel 3's forward on the card (its plain version on the CPU);
    counts a launch on ``flash_attention.launches``."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if route(q, k, v) == "plain":
        return flash_attention_plain(q, k, v, window=window,
                                     softmax_scale=scale)
    _check_heads(h, kv, hd, FWD_MAX_HEAD_DIM)
    if k.shape != (b, s, kv, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if q.dtype == torch.bfloat16:
        flash_forward_smem_bytes(hd)   # raises for a head_dim it cannot take
    q, k, v = (aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    rc = _bind("flash_forward_launch", 4, 6)(
        _build.dtype_code(q.dtype), _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        b, s, h, kv, hd, -1 if window is None else int(window), scale,
        device_limits(q.device).smem_block, _build.stream_ptr(),
    )
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_decode_attention(
    q: torch.Tensor,               # (B, 1, H, hd)
    k_cache: torch.Tensor,         # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,       # (B,) valid entries (incl. the new token)
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step flash attention over a dense cache; each slot attends
    to its first ``cache_len`` entries.  Returns ``(B, 1, H, hd)``."""
    b, q_len, h, hd = q.shape
    if q_len != 1:
        raise ValueError(f"decode kernel expects q_len == 1, got {q_len}")
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    if route(q, k_cache, v_cache, cache_len) == "plain":
        return flash_decode_attention_plain(
            q, k_cache, v_cache, cache_len, window=window,
            softmax_scale=scale,
        )
    _check_heads(h, kv, hd)
    if k_cache.shape != (b, s_max, kv, hd) or v_cache.shape != k_cache.shape \
            or cache_len.shape != (b,):
        raise ValueError(
            f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} and "
            f"cache_len {tuple(cache_len.shape)} do not fit q "
            f"{tuple(q.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError("q and the caches must share one dtype")
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    lens = cache_len.to(torch.int32).contiguous()
    if q.dtype == torch.bfloat16:
        rc, out = _split_launch(q, k_cache, v_cache, None, lens, s_max, 0,
                                window, scale)
    else:
        out = torch.empty_like(q)
        rc = _bind("flash_decode_launch", 5, 6)(
            _build.dtype_code(q.dtype), _ptr(q), _ptr(k_cache),
            _ptr(v_cache), _ptr(lens), _ptr(out), b, s_max, h, kv, hd,
            -1 if window is None else int(window), scale,
            device_limits(q.device).smem_block, _build.stream_ptr(),
        )
    _build.check(rc, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


_FMT_CODES = {"nf4": 0, "int8": 1}


def _split_launch(q, k, v, tables, lens, extent: int, bs: int, window,
                  scale, codes=None):
    """The bf16 split decode over a dense cache (``tables`` None) or a pool
    of ``bs``-token blocks, of rows or, with ``codes = (fmt, k_scales,
    v_scales, quant_block)``, of NF4/int8 codes: a score pass of one block
    per (chunk of keys, KV head, slot), then a value pass of one block per
    (slice of head_dim, KV head, slot)."""
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    _check_heads(h, kvh, hd)
    plan = decode_plan(extent, hd, h // kvh)
    limit = device_limits(q.device).smem_block
    smem = plan.smem if codes is None else plan.quant_smem
    if smem > limit:
        raise ValueError(f"the split decode block needs {smem} bytes "
                         f"of shared memory; a block may use {limit}")
    out = torch.empty_like(q)
    # the score pass's output: (slot, head, position)
    scores = torch.empty(max(1, b * h * extent), dtype=torch.float32,
                         device=q.device)
    window = -1 if window is None else int(window)
    tail = (window, plan.chunk // KERNEL_BLOCK, plan.splits, plan.stages,
            scale, limit, _build.stream_ptr())
    null = ctypes.c_void_p(0)
    if codes is not None:
        fmt, ks, vs, quant_block = codes
        rc = _bind("quant_split_decode_launch", 10, 11)(
            fmt, _ptr(q), _ptr(k), _ptr(v), _ptr(ks), _ptr(vs),
            _ptr(codebook(q.device)) if fmt == 0 else null, _ptr(tables),
            _ptr(lens), _ptr(out), _ptr(scores), b, tables.shape[1], bs, h,
            kvh, hd, quant_block, *tail)
        return rc, out
    rc = _bind("split_decode_launch", 7, 11, n_lead=0)(
        _ptr(q), _ptr(k), _ptr(v), null if tables is None else _ptr(tables),
        _ptr(lens), _ptr(out), _ptr(scores), b,
        extent, 0 if tables is None else tables.shape[1], bs, h, kvh, hd,
        *tail)
    return rc, out


def _paged_launch(fmt: int, q, k, v, ks, vs, tables, lens, window, scale,
                  quant_block: int):
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    _check_heads(h, kvh, hd)
    smem = attention_smem_bytes(hd)
    limit = device_limits(q.device).smem_block
    if smem > limit:
        raise ValueError(f"the decode block needs {smem} bytes of shared "
                         f"memory; a block may use {limit}")
    q = q.contiguous()
    out = torch.empty_like(q)
    null = ctypes.c_void_p(0)
    rc = _bind("paged_decode_launch", 9, 8, n_lead=2)(
        _build.dtype_code(q.dtype), fmt, _ptr(q), _ptr(k), _ptr(v),
        null if ks is None else _ptr(ks), null if vs is None else _ptr(vs),
        _ptr(codebook(q.device)) if fmt == 0 else null, _ptr(tables),
        _ptr(lens), _ptr(out), b, tables.shape[1], k.shape[1], h, kvh, hd,
        quant_block, -1 if window is None else int(window), scale, limit,
        _build.stream_ptr(),
    )
    return rc, out


def _tables_and_lens(block_tables, cache_len, b):
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or cache_len.shape != (b,):
        raise ValueError(
            f"block tables {tuple(block_tables.shape)} and cache_len "
            f"{tuple(cache_len.shape)} do not fit {b} slots")
    return (block_tables.to(torch.int32).contiguous(),
            cache_len.to(torch.int32).contiguous())


def paged_flash_decode_attention(
    q: torch.Tensor,               # (B, 1, H, hd)
    k_pool: torch.Tensor,          # (n_blocks, bs, KV, hd)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,    # (B, n_b) pool rows
    cache_len: torch.Tensor,       # (B,) valid entries (incl. the new token)
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    kv_quant: Optional[str] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    quant_block: int = 64,
    value_dtype=None,
) -> torch.Tensor:
    """Single-step flash attention over a paged pool: slot ``b``'s logical
    block ``j`` is pool row ``block_tables[b, j]``; entries past the
    slot's block count must repeat its last row (they are never read).
    ``kv_quant`` ("nf4" | "int8") takes code pools and their scale pools
    (:func:`paged_flash_decode_attention_quant`).  Returns ``(B, 1, H,
    hd)``."""
    if kv_quant is not None:
        return paged_flash_decode_attention_quant(
            q, k_pool, k_scales, v_pool, v_scales, block_tables, cache_len,
            kv_quant=kv_quant, quant_block=quant_block,
            value_dtype=value_dtype, window=window,
            softmax_scale=softmax_scale)
    b, q_len, h, hd = q.shape
    if q_len != 1:
        raise ValueError(f"decode kernel expects q_len == 1, got {q_len}")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    if route(q, k_pool, v_pool, block_tables, cache_len) == "plain":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_tables, cache_len, window=window,
            softmax_scale=scale)
    if k_pool.dim() != 4 or k_pool.shape[3] != hd \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError("q and the pools must share one dtype")
    tables, lens = _tables_and_lens(block_tables, cache_len, b)
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    bs = k_pool.shape[1]
    extent = tables.shape[1] * bs
    if q.dtype == torch.bfloat16:
        rc, out = _split_launch(q.contiguous(), k_pool, v_pool, tables, lens,
                                extent, bs, window, scale)
    else:
        rc, out = _paged_launch(-1, q, k_pool, v_pool, None, None, tables,
                                lens, window, scale, 0)
    _build.check(rc, "paged_flash_decode_attention")
    paged_flash_decode_attention.launches += 1
    return out


def paged_flash_decode_attention_quant(
    q: torch.Tensor,               # (B, 1, H, hd)
    k_codes: torch.Tensor,         # (n_blocks, bs, KV, hd//2) u8 | hd i8
    k_scales: torch.Tensor,        # (n_blocks, bs, KV, ceil(hd/qb)) fp32
    v_codes: torch.Tensor,
    v_scales: torch.Tensor,
    block_tables: torch.Tensor,    # (B, n_b) pool rows
    cache_len: torch.Tensor,       # (B,)
    *,
    kv_quant: str,
    quant_block: int = 64,
    value_dtype=None,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step flash attention over paged NF4/int8 code pools: each
    key and value element is decoded (codebook entry or int8 code, times
    the fp32 scale of its ``quant_block`` slice of head_dim) and rounded
    to ``value_dtype`` (default q's) in shared memory.  bf16 takes the
    split decode of the bf16 rows with a code loader, which keeps the bits
    of the one-block walk that float32 runs.  Returns ``(B, 1, H, hd)``."""
    b, q_len, h, hd = q.shape
    if q_len != 1:
        raise ValueError(f"decode kernel expects q_len == 1, got {q_len}")
    if kv_quant not in _FMT_CODES:
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    if k_scales is None or v_scales is None:
        raise ValueError("kv_quant needs k_scales and v_scales")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    if route(q, k_codes, k_scales, v_codes, v_scales, block_tables,
             cache_len) == "plain":
        return paged_decode_attention_plain(
            q, k_codes, v_codes, block_tables, cache_len, window=window,
            softmax_scale=scale, kv_quant=kv_quant, k_scales=k_scales,
            v_scales=v_scales, quant_block=quant_block,
            value_dtype=value_dtype)
    if (value_dtype or q.dtype) != q.dtype:
        raise ValueError("the kernel decodes to q's dtype; value_dtype "
                         f"{value_dtype} differs from {q.dtype}")
    code_dt, width = ((torch.uint8, hd // 2) if kv_quant == "nf4"
                      else (torch.int8, hd))
    if kv_quant == "nf4" and hd % 2:
        raise ValueError(f"NF4 pools need an even head_dim, got {hd}")
    lead = k_codes.shape[:3]
    if k_codes.dim() != 4 or k_codes.dtype != code_dt \
            or k_codes.shape[3] != width or v_codes.shape != k_codes.shape \
            or v_codes.dtype != code_dt:
        raise ValueError(f"{kv_quant} code pools {tuple(k_codes.shape)} "
                         f"{k_codes.dtype} do not fit q {tuple(q.shape)}")
    nsb = -(-hd // quant_block)
    for s in (k_scales, v_scales):
        if s.shape != (*lead, nsb) or s.dtype != torch.float32:
            raise ValueError(f"scale pool {tuple(s.shape)} {s.dtype} is not "
                             f"fp32 {(*lead, nsb)}")
    tables, lens = _tables_and_lens(block_tables, cache_len, b)
    fmt = _FMT_CODES[kv_quant]
    k_codes, v_codes = k_codes.contiguous(), v_codes.contiguous()
    k_scales, v_scales = k_scales.contiguous(), v_scales.contiguous()
    if q.dtype == torch.bfloat16:
        rc, out = _split_launch(
            q.contiguous(), k_codes, v_codes, tables, lens,
            tables.shape[1] * k_codes.shape[1], k_codes.shape[1], window,
            scale, codes=(fmt, k_scales, v_scales, int(quant_block)))
    else:
        rc, out = _paged_launch(fmt, q, k_codes, v_codes, k_scales, v_scales,
                                tables, lens, window, scale, int(quant_block))
    _build.check(rc, "paged_flash_decode_attention_quant")
    paged_flash_decode_attention_quant.launches += 1
    return out


flash_attention.launches = 0
flash_decode_attention.launches = 0
paged_flash_decode_attention.launches = 0
paged_flash_decode_attention_quant.launches = 0
