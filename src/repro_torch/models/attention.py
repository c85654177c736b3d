"""Attention behind a backend switch (port of
``repro/models/attention.py``).

* ``backend="reference"`` -- plain PyTorch: blockwise causal attention
  over query blocks, and the masked-softmax decode over the whole cache.
* ``backend="pallas"`` -- the hand-written CUDA flash kernels
  (``kernels/flash_attention.py``; the name is the JAX package's, kept so
  that configs carry over).  On CPU tensors their wrappers run the plain
  versions.  With grad on, the flash forward runs inside its
  ``autograd.Function``, whose backward recomputes over query blocks of
  ``q_block`` rows; the decode kernels are forward only.

GQA layout: ``q (B, S, H, hd)``, ``k/v (B, S, KV, hd)``, ``H % KV == 0``.
``q_block`` and ``fast_softmax`` are knobs of the reference path: the
kernels take their own 64-row tiles and always keep fp32 softmax
statistics with ``p`` cast to v's dtype, so they refuse ``fast_softmax``.
Paged decode (:func:`paged_decode_attention`) reads a block pool through
per-slot tables, optionally of NF4/int8 codes.  Chunked-prefill
attention (:func:`chunk_attention`) is plain PyTorch, as in the JAX
package.

Sharded paged decode (``paged_decode_attention(mesh=)``, the JAX
package's ``shard_map`` branch): the pool's block axis is split over the
mesh's DP axes in arenas that the allocator keeps apart
(``serve/paging.PagedCacheView(data_shards=)``), so each data rank runs
the paged decode once on its own batch rows and its own arena, with its
tables shifted to arena rows (:func:`paged_decode_shard`, a plain
function of local tensors).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.dispatch import MASK_VALUE
from repro_torch.kernels.flash_attention import (
    _block_attend,
    blockwise_reference_attention,
    decode_reference_attention,
    flash_attention,
    flash_decode_attention,
    gather_kv,
    paged_flash_decode_attention,
)

__all__ = ["MASK_VALUE", "blockwise_causal_attention", "chunk_attention",
           "decode_attention", "paged_decode_attention",
           "paged_decode_shard", "local_paged_decode",
           "dp_shard_placements"]

_BACKENDS = ("reference", "pallas")


def _check_backend(backend: str, fast_softmax: bool) -> None:
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown attention backend {backend!r}; expected one of "
            f"{_BACKENDS}"
        )
    if backend == "pallas" and fast_softmax:
        raise ValueError("fast_softmax is a knob of the reference backend")


def blockwise_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_block: int = 512,
    window: Optional[int] = None,
    fast_softmax: bool = False,
    backend: str = "reference",
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention.  Returns ``(B, S, H,
    hd)``."""
    _check_backend(backend, fast_softmax)
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"n_heads {q.shape[2]} must be a multiple of n_kv_heads "
            f"{k.shape[2]}"
        )
    if backend == "pallas":
        return flash_attention(q, k, v, window=window, block_q=q_block)
    return blockwise_reference_attention(
        q, k, v, q_block=q_block, window=window, fast_softmax=fast_softmax,
    )


def chunk_attention(
    q: torch.Tensor,           # (B, C, H, hd), one prefill chunk
    k: torch.Tensor,           # (B, S_stage, KV, hd), the staging cache
    v: torch.Tensor,
    q_pos: torch.Tensor,       # (C,) absolute positions of the chunk
    *,
    window: Optional[int] = None,
    fast_softmax: bool = False,
) -> torch.Tensor:
    """Causal attention of one chunked-prefill piece: the chunk's queries
    at absolute positions ``q_pos`` attend over the whole staging buffer
    (keys at positions ``0..S_stage``), causally masked, so rows the chunk
    has not reached add nothing.  Returns ``(B, C, H, hd)``."""
    b, c, h, hd = q.shape
    kv = k.shape[2]
    out = _block_attend(
        q.reshape(b, c, kv, h // kv, hd), k, v, q_pos,
        torch.arange(k.shape[1], device=q.device), window,
        1.0 / math.sqrt(hd), fast_softmax,
    )
    return out.reshape(b, c, h, hd)


def decode_attention(
    q: torch.Tensor,           # (B, 1, H, hd)
    k_cache: torch.Tensor,     # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,   # (B,) valid entries (incl. the new token)
    *,
    window: Optional[int] = None,
    fast_softmax: bool = False,
    backend: str = "reference",
) -> torch.Tensor:
    """Single-step attention over a dense cache.  Returns ``(B, 1, H,
    hd)``."""
    _check_backend(backend, fast_softmax)
    if backend == "pallas":
        return flash_decode_attention(q, k_cache, v_cache, cache_len,
                                      window=window)
    return decode_reference_attention(
        q, k_cache, v_cache, cache_len, window=window,
        fast_softmax=fast_softmax,
    )


def paged_decode_shard(
    q: torch.Tensor,               # (B_local, 1, H, hd)
    k_pool: torch.Tensor,          # (arena_rows, bs, KV, hd) or codes
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,    # (B_local, max_blocks) GLOBAL pool rows
    cache_len: torch.Tensor,       # (B_local,)
    shard: int,
    *,
    window: Optional[int] = None,
    fast_softmax: bool = False,
    backend: str = "pallas",
    kv_quant: Optional[str] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    quant_block: int = 64,
    value_dtype=None,
) -> torch.Tensor:
    """One data shard's paged decode: its batch rows over its arena of the
    pool (``k_pool.shape[0]`` rows), through its tables shifted by
    ``shard * arena_rows`` to arena rows.  ``backend="pallas"`` launches
    the paged flash decode (kernel 5, kernel 6 over codes); the reference
    gathers the arena into a dense view."""
    local = block_tables - shard * k_pool.shape[0]
    return paged_decode_attention(
        q, k_pool, v_pool, local, cache_len, window=window,
        fast_softmax=fast_softmax, backend=backend, kv_quant=kv_quant,
        k_scales=k_scales, v_scales=v_scales, quant_block=quant_block,
        value_dtype=value_dtype)


def dp_shard_placements(mesh):
    """Placements of a tensor split on its first dim over the mesh's DP
    axes and replicated over the rest (``P(dp)``)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import dp_axes

    dp = dp_axes(mesh)
    return [Shard(0) if a in dp else Replicate()
            for a in mesh.mesh_dim_names]


def _sharded_paged_flash(q, k_pool, v_pool, block_tables, cache_len,
                         window, mesh, fast_softmax=False,
                         backend="pallas", kv_quant=None,
                         k_scales=None, v_scales=None, quant_block=64,
                         value_dtype=None):
    """The paged decode once per data shard (``shard_map`` over the DP
    axes).  Inputs are global: DTensors (resharded to ``P(dp)`` when they
    are not) or plain tensors that every rank holds whole.  Returns
    ``None`` where the mesh cannot split the call (no DP axis, batch or
    pool rows that the DP size does not divide): the caller then takes the
    global-table path.  Else the output as a DTensor split ``P(dp)``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import dp_index, dp_size

    d_total = dp_size(mesh)
    b, n_pool = q.shape[0], k_pool.shape[0]
    if d_total <= 1 or b % d_total or n_pool % d_total:
        return None
    shard = dp_index(mesh)
    place = dp_shard_placements(mesh)

    def local(t):
        if t is None:
            return None
        if isinstance(t, DTensor):
            return t.redistribute(mesh, place).to_local()
        rows = t.shape[0] // d_total
        return t.narrow(0, shard * rows, rows)

    out = paged_decode_shard(
        local(q), local(k_pool), local(v_pool), local(block_tables),
        local(cache_len), shard, window=window, fast_softmax=fast_softmax,
        backend=backend, kv_quant=kv_quant, k_scales=local(k_scales),
        v_scales=local(v_scales), quant_block=quant_block,
        value_dtype=value_dtype)
    return DTensor.from_local(out, mesh, place, run_check=False)


def local_paged_decode(q, k_pool, v_pool, block_tables, cache_len, mesh,
                       *, k_scales=None, v_scales=None, **kw):
    """:func:`paged_decode_attention` under ``mesh`` from a data rank's
    own tensors: its batch rows (GLOBAL pool rows in their tables) and
    its arena of the pools, taken as the shards of ``P(dp)``-split
    DTensors.  Returns this rank's rows of the output."""
    from torch.distributed.tensor import DTensor

    place = dp_shard_placements(mesh)

    def wrap(t):
        return None if t is None else DTensor.from_local(
            t, mesh, place, run_check=False)

    out = paged_decode_attention(
        wrap(q), wrap(k_pool), wrap(v_pool), wrap(block_tables),
        wrap(cache_len), k_scales=wrap(k_scales), v_scales=wrap(v_scales),
        mesh=mesh, **kw)
    return out.to_local()


def paged_decode_attention(
    q: torch.Tensor,               # (B, 1, H, hd), one new token
    k_pool: torch.Tensor,          # (n_blocks, bs, KV, hd) or codes
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,    # (B, max_blocks) pool rows
    cache_len: torch.Tensor,       # (B,) valid entries (incl. the new token)
    *,
    window: Optional[int] = None,
    fast_softmax: bool = False,
    backend: str = "reference",
    kv_quant: Optional[str] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    quant_block: int = 64,
    value_dtype=None,
    mesh=None,
) -> torch.Tensor:
    """Single-step attention over a paged pool.  Returns ``(B, 1, H,
    hd)``.

    Table entries past a slot's block count must repeat its last row
    (``serve/paging.PagedCacheView.device_tables``).  ``kv_quant`` marks
    the pools as codes with scale pools ``k_scales``/``v_scales``
    (``core.quantize.quantize_kv`` layout), decoded and cast to
    ``value_dtype`` (default q's) before attention.  ``backend="pallas"``
    takes the paged flash kernels; the reference path gathers the pool
    into a dense view and runs the dense reference decode.

    ``mesh`` (a ``DeviceMesh``; the serving engine passes it only when the
    pool's arenas match its DP axes) runs the decode once per data shard
    (:func:`_sharded_paged_flash`) on global inputs and returns a
    ``P(dp)``-split DTensor; where the mesh cannot split the call, the
    global-table path runs, as in the JAX package.
    """
    _check_backend(backend, fast_softmax)
    if kv_quant is not None and (k_scales is None or v_scales is None):
        raise ValueError("kv_quant needs k_scales and v_scales")
    if mesh is not None:
        out = _sharded_paged_flash(
            q, k_pool, v_pool, block_tables, cache_len, window, mesh,
            fast_softmax=fast_softmax, backend=backend, kv_quant=kv_quant,
            k_scales=k_scales, v_scales=v_scales, quant_block=quant_block,
            value_dtype=value_dtype)
        if out is not None:
            return out
    if backend == "pallas":
        return paged_flash_decode_attention(
            q, k_pool, v_pool, block_tables, cache_len, window=window,
            kv_quant=kv_quant, k_scales=k_scales, v_scales=v_scales,
            quant_block=quant_block, value_dtype=value_dtype,
        )
    k, v = gather_kv(q, k_pool, v_pool, block_tables, kv_quant=kv_quant,
                     k_scales=k_scales, v_scales=v_scales,
                     quant_block=quant_block, value_dtype=value_dtype)
    return decode_reference_attention(
        q, k, v, cache_len, window=window, fast_softmax=fast_softmax,
    )
