"""Paged KV cache, host-side control plane (port of
``repro/serve/paging.py``).

* :class:`BlockAllocator` -- a LIFO free list over ``n_blocks`` pool
  blocks of ``block_size`` tokens.  Block 0 is the null block: it is never
  handed out, and scatter padding and the decode writes of freed slots
  land there, so every device-side shape stays fixed.
* :class:`PagedCacheView` -- the pool layout of a model's cache (from its
  ``cache_spec()`` and dense ``init_cache`` shapes), the per-slot block
  tables (allocate on admission, extend on append, free on eviction) and
  the device table that ``decode_step`` and ``insert_cache`` read.  Entries
  past a slot's block count repeat its last row; the table is one device
  buffer, refreshed in place (``copy_`` from pinned host memory) only after
  an edit, so a captured decode graph reads it at every replay.  Under
  ``kv_quant`` the float pools hold NF4 or int8 codes plus
  ``<key>_qscale`` fp32 scale pools.
* Accounting: blocks in use, bytes allocated and peak utilization, which
  ``ServingEngine.stats`` reports.

Sharded pools (``data_shards > 1``): the pool splits into equal arenas,
one a data shard, each with its own allocator and its own null block (the
arena's local row 0).  Slot ``s`` belongs to shard ``s // (n_slots /
data_shards)`` (the contiguous chunks of a ``P(dp)`` slot split) and
allocates from its arena alone; tables hold GLOBAL pool rows (``shard *
arena_size + local``), so the paged decode of one shard reads its arena
through ``table - shard * arena_size`` (``models/attention.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.dispatch import upload
from repro_torch.models.common import PagedCacheLeafSpec

__all__ = ["BlockAllocator", "PagedCacheView", "NULL_BLOCK",
           "addressable_nbytes"]

NULL_BLOCK = 0


def addressable_nbytes(leaf: torch.Tensor) -> int:
    """Device bytes this rank holds of ``leaf``: a DTensor's local shard,
    else the tensor's size in bytes."""
    local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
    return int(local.numel() * local.element_size())


class BlockAllocator:
    """LIFO free list over ``n_blocks`` pool blocks; ``NULL_BLOCK`` is
    reserved.  Double and foreign frees raise."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least one allocatable block + null")
        self.n_blocks = n_blocks
        # pop() hands out low ids first; the set keeps the double-free
        # check O(1) per block
        self._free: List[int] = list(range(n_blocks - 1, NULL_BLOCK, -1))
        self._free_set = set(self._free)
        self.peak_in_use = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged cache out of blocks: want {n}, have {len(self._free)}"
            )
        blocks = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(blocks)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return blocks

    def free(self, blocks) -> None:
        for b in blocks:
            b = int(b)
            if not (NULL_BLOCK < b < self.n_blocks):
                raise ValueError(f"freeing invalid block id {b}")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)
            self._free_set.add(b)


class PagedCacheView:
    """Paged layout and block tables of one model's decode cache.

    ``tokens_per_slot`` is the dense token extent (``max_len``); a slot
    never holds more than ``ceil(tokens_per_slot / block_size)`` blocks.
    ``n_blocks`` defaults to the worst case (every slot full) plus the null
    block; a smaller pool overcommits, and the engine preempts when it runs
    out.  A paged leaf whose spec carries ``kv_quant`` ("nf4" | "int8", from
    the model's ``cfg.kv_quant``) is stored as codes plus a ``<key>_qscale``
    pool of scales per ``quant_block`` elements of the last axis;
    ``serve_spec`` is the spec of that serving cache, and the byte gauges
    count the packed bytes.  ``data_shards > 1`` partitions the pool into
    that many equal arenas (``n_blocks`` rounded up to a multiple; by
    default every slot full plus one null block an arena).
    """

    def __init__(self, model, n_slots: int, max_len: int, block_size: int,
                 n_blocks: Optional[int] = None, data_shards: int = 1):
        if block_size < 1:
            raise ValueError("block_size must be positive")
        if data_shards < 1:
            raise ValueError("data_shards must be positive")
        self.n_slots = n_slots
        self.block_size = block_size
        self.device = model.device
        self.spec = model.cache_spec()
        dense = model.init_cache(n_slots, max_len, device="meta")
        self._dense_shapes = {k: (tuple(t.shape), t.dtype)
                              for k, t in dense.items()}
        extents = {self._dense_shapes[k][0][ls.page_axis]
                   for k, ls in self.spec.items()
                   if isinstance(ls, PagedCacheLeafSpec)}
        if len(extents) > 1:
            raise ValueError(f"paged leaves disagree on extent: {extents}")
        self.paged = bool(extents)
        self.data_shards = data_shards if self.paged else 1
        if self.paged and n_slots % self.data_shards:
            raise ValueError(
                f"n_slots {n_slots} must divide evenly across "
                f"{self.data_shards} data shards")
        self.tokens_per_slot = extents.pop() if extents else 0
        self.max_blocks_per_slot = -(-self.tokens_per_slot // block_size)
        if n_blocks is None:
            n_blocks = n_slots * self.max_blocks_per_slot + self.data_shards
        elif n_blocks % self.data_shards:
            n_blocks += self.data_shards - n_blocks % self.data_shards
        self.n_blocks = n_blocks if self.paged else 0
        self.arena_size = n_blocks // self.data_shards if self.paged else 0
        # one allocator an arena, handing out LOCAL rows 1..arena_size-1
        self._arenas = ([BlockAllocator(self.arena_size)
                         for _ in range(self.data_shards)]
                        if self.paged else None)
        # the one allocator of an unsharded pool
        self.allocator = (self._arenas[0]
                          if self.paged and self.data_shards == 1 else None)
        self._tables = np.full(
            (n_slots, max(self.max_blocks_per_slot, 1)), NULL_BLOCK, np.int32)
        if self.paged:
            for slot in range(n_slots):
                self._tables[slot, :] = self.null_of(self.shard_of(slot))
        self._counts = np.zeros((n_slots,), np.int32)
        self._device_tables = torch.empty(self._tables.shape,
                                          dtype=torch.int32,
                                          device=self.device)
        self._dirty = True           # the device table misses an edit
        self.uploads = 0
        self._bytes_per_block = 0.0   # filled by init_cache
        self._dense_bytes = 0         # filled by init_cache
        self._local_arena = None      # the arena a placed cache holds
        self.kv_quant = None          # resolved per leaf below
        self.serve_spec, self._serve_shapes = self._apply_kv_quant()

    # ------------------------------------------------------ quantized pools
    def _apply_kv_quant(self):
        """(spec, shapes) of the serving cache: every float paged leaf
        whose spec sets ``kv_quant`` becomes a code leaf plus a
        ``<key>_qscale`` scale leaf; other leaves pass through, with a
        ``kv_quant`` flag stripped where it cannot apply."""
        spec, shapes = self.spec, self._dense_shapes
        if not self.paged:
            return spec, shapes
        out_spec: Dict[str, Any] = {}
        out_shapes: Dict[str, Any] = {}
        for key, ls in spec.items():
            shape, dt = shapes[key]
            fmt = getattr(ls, "kv_quant", None)
            if not (isinstance(ls, PagedCacheLeafSpec) and fmt is not None
                    and dt.is_floating_point):
                if isinstance(ls, PagedCacheLeafSpec) and ls.kv_quant:
                    ls = dataclasses.replace(ls, kv_quant=None)
                out_spec[key] = ls
                out_shapes[key] = (shape, dt)
                continue
            d, qb = shape[-1], ls.quant_block
            if fmt == "nf4" and d % 2:
                raise ValueError(
                    f"nf4 KV needs an even head_dim, got {d} for {key!r}")
            out_spec[key] = ls
            out_shapes[key] = ((shape[:-1] + (d // 2,), torch.uint8)
                               if fmt == "nf4" else (shape, torch.int8))
            out_spec[key + "_qscale"] = dataclasses.replace(
                ls, kv_quant=None, fill=0)
            out_shapes[key + "_qscale"] = (shape[:-1] + (-(-d // qb),),
                                           torch.float32)
            self.kv_quant = fmt
        return out_spec, out_shapes

    # ------------------------------------------------------------- sharding
    def shard_of(self, slot: int) -> int:
        """Data shard owning ``slot`` (contiguous chunks of slots)."""
        if not self.paged or self.data_shards == 1:
            return 0
        return int(slot) // (self.n_slots // self.data_shards)

    def null_of(self, shard: int) -> int:
        """Global pool row of ``shard``'s null block (its arena's row 0)."""
        return shard * self.arena_size

    @property
    def max_request_blocks(self) -> int:
        """Most blocks one request can hold: its arena minus the arena's
        null block."""
        return self.arena_size - 1

    # ----------------------------------------------------------- pool init
    def _pool_shape(self, ls: PagedCacheLeafSpec, dense_shape):
        s_ax, p_ax = ls.slot_axis, ls.page_axis
        if p_ax != s_ax + 1:
            raise ValueError("paged leaf needs page_axis == slot_axis + 1")
        return (dense_shape[:s_ax] + (self.n_blocks, self.block_size)
                + dense_shape[p_ax + 1:])

    def struct(self) -> Dict[str, Any]:
        """``(shape, dtype)`` of every leaf of the serving cache."""
        return {
            key: ((self._pool_shape(ls, shape), dt)
                  if self.paged and isinstance(ls, PagedCacheLeafSpec)
                  else (shape, dt))
            for key, ls in self.serve_spec.items()
            for shape, dt in [self._serve_shapes[key]]
        }

    def meta_struct(self) -> Dict[str, torch.Tensor]:
        """:meth:`struct` as ``meta`` tensors (what the sharding rules
        take)."""
        return {key: torch.empty(shape, dtype=dt, device="meta")
                for key, (shape, dt) in self.struct().items()}

    def init_cache(self, mesh=None, specs=None) -> Dict[str, torch.Tensor]:
        """Zero-filled serving cache on the model's device: block pools for
        paged leaves, the dense layout otherwise.  With a ``DeviceMesh``
        and ``launch.shardings.cache_shardings`` ``specs``, each leaf is a
        DTensor of which this rank allocates its shard only (its arena of
        a DP-split pool).  Sets the byte gauges from what this rank holds:
        a block's bytes are the local pool bytes over the local pool
        rows."""
        if mesh is None:
            cache = {key: torch.zeros(shape, dtype=dt, device=self.device)
                     for key, (shape, dt) in self.struct().items()}
        else:
            from repro_torch.launch.mesh import dp_index
            from repro_torch.launch.shardings import placed_zeros

            cache = placed_zeros(self.meta_struct(), mesh, specs, self.device)
        per_block, dense, split = 0.0, 0, False
        for key, ls in self.serve_spec.items():
            leaf = cache[key]
            if self.paged and isinstance(ls, PagedCacheLeafSpec):
                rows = (leaf.to_local() if mesh is not None
                        else leaf).shape[ls.slot_axis]
                split = split or rows != self.n_blocks
                per_block += addressable_nbytes(leaf) / rows
            else:
                dense += addressable_nbytes(leaf)
        self._bytes_per_block = per_block
        self._dense_bytes = dense
        # a rank holding one arena bills that arena's blocks
        self._local_arena = dp_index(mesh) if split else None
        return cache

    # ------------------------------------------------------- block tables
    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a slot needs to hold ``n_tokens``."""
        return -(-min(n_tokens, self.tokens_per_slot) // self.block_size)

    def can_admit(self, n_tokens: int, slot: int = 0) -> bool:
        """Whether ``slot``'s arena can hold ``n_tokens`` now."""
        return (not self.paged) or (
            self.blocks_for(n_tokens)
            <= self._arenas[self.shard_of(slot)].available)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s table to cover ``n_tokens`` (alloc on append).
        Out of blocks, it raises ``MemoryError`` and changes nothing."""
        if not self.paged:
            return
        need = self.blocks_for(n_tokens)
        have = int(self._counts[slot])
        if need <= have:
            return
        shard = self.shard_of(slot)
        local = self._arenas[shard].alloc(need - have)
        base = self.null_of(shard)
        self._tables[slot, have:need] = [base + b for b in local]
        self._counts[slot] = need
        self._dirty = True

    def release(self, slot: int) -> None:
        if not self.paged:
            return
        shard = self.shard_of(slot)
        base = self.null_of(shard)
        c = int(self._counts[slot])
        if c:
            self._arenas[shard].free(self._tables[slot, :c] - base)
        self._tables[slot, :] = base
        self._counts[slot] = 0
        self._dirty = True

    def host_tables(self) -> np.ndarray:
        """``(n_slots, max_blocks_per_slot)`` int32: entries past a slot's
        block count repeat its last block, so a reader that stops at the
        slot's length never needs them; freed rows are all null."""
        t = self._tables.copy()
        for slot in range(self.n_slots):
            c = int(self._counts[slot])
            if 0 < c < t.shape[1]:
                t[slot, c:] = t[slot, c - 1]
        return t

    def device_tables(self) -> torch.Tensor:
        """:meth:`host_tables` on the device: always the same buffer,
        refreshed in place only after a table edit (``uploads`` counts the
        refreshes)."""
        if self._dirty:
            upload(self._device_tables, self.host_tables())
            self._dirty = False
            self.uploads += 1
        return self._device_tables

    def wave_page_extent(self, wave_cache) -> int:
        """Token extent of a prefill wave's paged leaves."""
        for key, ls in self.spec.items():
            if isinstance(ls, PagedCacheLeafSpec):
                return wave_cache[key].shape[ls.page_axis]
        raise ValueError("wave cache has no paged leaves")

    def wave_tables(self, slot_ids, n_logical_blocks: int) -> np.ndarray:
        """``(len(slot_ids), n_logical_blocks)`` scatter table of a prefill
        wave: each row's blocks, then its arena's null block as padding."""
        out = np.full((len(slot_ids), n_logical_blocks), NULL_BLOCK,
                      np.int32)
        for row, slot in enumerate(slot_ids):
            c = min(int(self._counts[slot]), n_logical_blocks)
            out[row, :] = self.null_of(self.shard_of(int(slot)))
            out[row, :c] = self._tables[slot, :c]
        return out

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        if not self.paged:
            return {
                "blocks_in_use": 0,
                "blocks_total": 0,
                "peak_blocks_in_use": 0,
                "cache_bytes_allocated": int(self._dense_bytes),
                "peak_block_utilization": 0.0,
                "kv_quant": None,
            }
        in_use = sum(a.in_use for a in self._arenas)
        usable = self.n_blocks - self.data_shards     # minus arena nulls
        # per-arena peaks may fall on different ticks: their sum bounds
        # the concurrent peak from above
        peak = sum(a.peak_in_use for a in self._arenas)
        held = (in_use if self._local_arena is None
                else self._arenas[self._local_arena].in_use)
        return {
            "blocks_in_use": in_use,
            "blocks_total": usable,
            "peak_blocks_in_use": peak,
            "cache_bytes_allocated": int(
                self._dense_bytes + held * self._bytes_per_block),
            "peak_block_utilization": peak / usable,
            "kv_quant": self.kv_quant,
        }
