"""Adapter lifecycle: a tenant registry and a fixed-capacity resident bank
whose rows are swapped in place (port of ``repro/serve/adapter_pool.py``).

* :class:`AdapterStore` -- the registry.  Tenants are kept as their
  adapter tensors (normalized by ``core.bank.tenant_path_adapters``, so a
  folded-QuanTA tenant carries its ``RebasedAdapter`` base), wherever the
  caller keeps them (host memory for a large registry).  Append-only up to
  ``max_tenants``; registration order fixes each tenant's global id, which
  requests carry through every residency change.
* :class:`AdapterPool` -- the resident bank: the ``core.bank`` layout with
  ``capacity + 1`` rows per structure group (row 0 neutral).  The engine
  reads it through :meth:`AdapterPool.device_bank`, whose tensors are
  never reallocated: ``load`` copies a tenant into free rows in place
  (``copy_``) and points its ``id_maps`` entries at them, so a kernel that
  reads the bank by pointer sees the new rows at the next call.
  ``evict`` zeroes the id_map entries and frees the rows.

Eviction is LRU by serving traffic (``acquire``/``release``/``load`` stamp
a monotonic clock); pins are refcounted.  ``ServingEngine`` acquires a
tenant at admission (the last admission check: an unloadable tenant defers
the request) and releases it when the request leaves its slot, so an
in-flight tenant cannot be evicted (``evict`` returns False).

Under a mesh, :meth:`AdapterPool.place` places the resident bank by
``launch.shardings.peft_shardings``' adapter rule: replicated, a whole
copy on every rank, so every rank swaps the same rows in place.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.adapters import tree_map, tree_nbytes
from repro_torch.core.bank import (
    AdapterBank, TenantEntry, _BankPath, _bank_path, _stacked_layout,
    adapter_signature, tenant_path_adapters,
)
from repro_torch.core.peft import _set_path, flatten_paths
from repro_torch.serve.metrics import LatencyHistogram

__all__ = ["AdapterPool", "AdapterStore", "RowAllocator"]


class RowAllocator:
    """LIFO free list over bank rows ``1..capacity`` (row 0, the neutral,
    is never handed out).  Double and foreign frees raise."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("need at least one resident row")
        self.capacity = capacity
        # pop() hands out low rows first; the set guards double frees
        self._free: List[int] = list(range(capacity, 0, -1))
        self._free_set = set(self._free)
        self.peak_in_use = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise MemoryError("adapter bank full: no free resident rows")
        row = self._free.pop()
        self._free_set.discard(row)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return row

    def free(self, row: int) -> None:
        row = int(row)
        if not (0 < row <= self.capacity):
            raise ValueError(f"freeing invalid bank row {row}")
        if row in self._free_set:
            raise ValueError(f"double free of bank row {row}")
        self._free.append(row)
        self._free_set.add(row)


def _bank_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a nested dict of bank paths."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _bank_tensors(v)]
    return list(tree.tensors())


class AdapterStore:
    """Tenant registry: name -> adapter tensors.

    ``register`` takes what ``AdapterBank.build`` takes per tenant (an
    ``AdapterSet``, or the ``(params, adapter_set)`` pair of a folded
    QuanTA attach).  Registration order fixes the global ids ``1 ..
    max_tenants`` (0 = the base model); ``max_tenants`` sizes the resident
    bank's ``id_maps``.
    """

    def __init__(self, *, max_tenants: int):
        if max_tenants < 1:
            raise ValueError("max_tenants must be positive")
        self.max_tenants = max_tenants
        self._names: List[str] = []
        self._members: Dict[str, Dict[str, Tuple[Any, Any]]] = {}

    def register(self, name: str, entry: TenantEntry) -> int:
        """Register a trained tenant; returns its global id."""
        if name in self._members:
            raise ValueError(f"tenant {name!r} already registered")
        if len(self._names) >= self.max_tenants:
            raise ValueError(
                f"registry full: max_tenants={self.max_tenants} (sized at "
                "construction: it bounds the resident bank's id_map extent)")
        self._members[name] = tenant_path_adapters(name, entry)
        self._names.append(name)
        return len(self._names)

    def get(self, name: str) -> Dict[str, Tuple[Any, Any]]:
        """Flat ``path -> (adapter, leaf_spec)`` of one tenant."""
        try:
            return self._members[name]
        except KeyError:
            raise KeyError(
                f"unknown adapter {name!r}; registry holds "
                f"{len(self._names)} tenant(s)") from None

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._names)

    @property
    def num_tenants(self) -> int:
        return len(self._names)

    def id_of(self, name: Optional[str]) -> int:
        """Global adapter id (``None`` -> 0, the base model)."""
        if name is None:
            return 0
        self.get(name)                       # unknown tenants raise
        return 1 + self._names.index(name)

    @property
    def nbytes(self) -> int:
        """Registry bytes: every registered tenant's tensors."""
        return sum(tree_nbytes(adapter)
                   for members in self._members.values()
                   for adapter, _ in members.values())


class AdapterPool:
    """Fixed-capacity resident bank over an :class:`AdapterStore`.

    Build with :meth:`build`; serve with ``ServingEngine(model, params,
    adapters=pool)``.  Has the engine-facing surface of ``AdapterBank``
    (``id_of``, ``num_tenants``); the model reads :meth:`device_bank`.
    """

    def __init__(self, store: AdapterStore, capacity: int,
                 tree: Dict[str, Any], gindex: Dict[str, Dict[Any, int]]):
        self.store = store
        self.capacity = capacity
        self.tree = tree
        self._gindex = gindex                  # path -> {signature: group}
        self._bank = AdapterBank(tree=tree, names=())
        self._alloc: Dict[Tuple[str, int], RowAllocator] = {
            (path, gi): RowAllocator(capacity)
            for path, sigs in gindex.items() for gi in sigs.values()
        }
        # name -> {"rows": {(path, group): row}, "pins": int, "stamp": int}
        self._resident: Dict[str, Dict[str, Any]] = {}
        self._clock = 0
        self.loads = 0
        self.evictions = 0
        self.acquire_denied = 0
        self.evict_denied = 0
        self.swap_hist = LatencyHistogram()
        self._placed_mesh = None
        self.placement = None         # the resident bank's specs, once placed

    @staticmethod
    def build(base_params: Dict[str, Any], store: AdapterStore, *,
              capacity: int) -> "AdapterPool":
        """The resident layout of the tenants registered so far: one group
        per structure signature per adapted path, each with ``capacity +
        1`` neutral rows, on the base weights' device (the registry may
        keep its tenants elsewhere).  Tenants registered later load as
        long as their structure matches a group."""
        if capacity < 1:
            raise ValueError("capacity must be positive")
        if store.num_tenants == 0:
            raise ValueError(
                "register at least one tenant before building the pool "
                "(group layout derives from tenant structures)")
        flat_base = flatten_paths(base_params)
        protos: Dict[str, Dict[Any, Tuple[Any, Any]]] = {}
        for name in store.names:
            for path, (adapter, spec) in sorted(store.get(name).items()):
                protos.setdefault(path, {}).setdefault(
                    adapter_signature(adapter), (adapter, spec))

        tree: Dict[str, Any] = {}
        gindex: Dict[str, Dict[Any, int]] = {}
        for path, per in sorted(protos.items()):
            stacked = _stacked_layout(path, (s for _, s in per.values()))
            w0 = flat_base[path]
            dev = (w0.device if isinstance(w0, torch.Tensor)
                   else w0.packed.device)           # a QuantizedLinear
            gindex[path] = {sig: gi for gi, sig in enumerate(per)}
            # no members yet: row 0 and the capacity rows are all neutral
            _set_path(tree, path, _bank_path(
                w0, stacked, [(proto, []) for proto, _ in per.values()],
                store.max_tenants + 1, dev, capacity))
        return AdapterPool(store, capacity, tree, gindex)

    # ------------------------------------------------------------ identity
    @property
    def num_tenants(self) -> int:
        return self.store.num_tenants

    def id_of(self, name: Optional[str]) -> int:
        return self.store.id_of(name)

    def device_bank(self) -> AdapterBank:
        """The bank the model reads: fixed tensors, rows swapped in
        place."""
        return self._bank

    @property
    def num_resident(self) -> int:
        return len(self._resident)

    def is_resident(self, name: str) -> bool:
        return name in self._resident

    def pins_of(self, name: str) -> int:
        ent = self._resident.get(name)
        return 0 if ent is None else ent["pins"]

    # ----------------------------------------------------------- lifecycle
    def _path_node(self, path: str) -> _BankPath:
        node = self.tree
        for k in path.split("/"):
            node = node[k]
        return node

    def _touch(self, name: str) -> None:
        self._clock += 1
        self._resident[name]["stamp"] = self._clock

    def _profile_of(self, name: str):
        profile = []
        for path, (adapter, _) in sorted(self.store.get(name).items()):
            gi = self._gindex.get(path, {}).get(adapter_signature(adapter))
            if gi is None:
                raise ValueError(
                    f"tenant {name!r} (registered after the pool was built) "
                    f"has a structure at {path!r} matching no resident "
                    "group; rebuild the pool to add new structure groups")
            profile.append((path, gi, adapter))
        return profile

    def _load(self, name: str, profile) -> None:
        """Copy the tenant into freshly allocated rows and point its
        id_map entries at them.  The caller made room in every group."""
        t0 = time.perf_counter()
        gid = self.store.id_of(name)
        rows: Dict[Tuple[str, int], int] = {}
        for path, gi, adapter in profile:
            row = rows[(path, gi)] = self._alloc[(path, gi)].alloc()
            node = self._path_node(path)
            if node.stacked:
                tree_map(lambda g, t: g[:, row].copy_(t), node.groups[gi],
                         adapter)
            else:
                tree_map(lambda g, t: g[row].copy_(t), node.groups[gi],
                         adapter)
            node.id_maps[gi][gid] = row
        dev = node.id_maps[0].device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)      # an honest swap-latency gauge
        self._resident[name] = {"rows": rows, "pins": 0, "stamp": 0}
        self._touch(name)
        self.loads += 1
        self.swap_hist.record(max(time.perf_counter() - t0, 0.0))

    def _evict(self, name: str) -> None:
        ent = self._resident.pop(name)
        gid = self.store.id_of(name)
        for (path, gi), row in ent["rows"].items():
            self._path_node(path).id_maps[gi][gid] = 0   # unreachable first
            self._alloc[(path, gi)].free(row)
        self.evictions += 1

    def _ensure_resident(self, name: str) -> bool:
        if name in self._resident:
            return True
        profile = self._profile_of(name)
        # make room group by group: evict the LRU unpinned occupant of
        # each full group (an eviction frees a row in every group the
        # victim occupies, so this makes progress)
        for path, gi, _ in profile:
            key = (path, gi)
            while self._alloc[key].available == 0:
                victims = [(ent["stamp"], n)
                           for n, ent in self._resident.items()
                           if ent["pins"] == 0 and key in ent["rows"]]
                if not victims:
                    return False             # every occupant is in flight
                self._evict(min(victims)[1])
        self._load(name, profile)
        return True

    def acquire(self, name: Optional[str]) -> bool:
        """Pin a tenant for an in-flight request, loading it (and evicting
        the LRU unpinned resident) if needed.  False: no row could be
        freed, the caller defers.  ``None`` (the base model) is always
        ready."""
        if name is None:
            return True
        if not self._ensure_resident(name):
            self.acquire_denied += 1
            return False
        self._resident[name]["pins"] += 1
        self._touch(name)
        return True

    def release(self, name: Optional[str]) -> None:
        """Unpin after the request left its slot; the tenant stays
        resident until it is evicted."""
        if name is None:
            return
        ent = self._resident.get(name)
        if ent is None or ent["pins"] <= 0:
            raise ValueError(
                f"release of tenant {name!r} without a matching acquire")
        ent["pins"] -= 1
        self._touch(name)

    def load(self, name: str) -> bool:
        """Make a tenant resident without pinning it (warm-up)."""
        ok = self._ensure_resident(name)
        if ok:
            self._touch(name)
        return ok

    def evict(self, name: str) -> bool:
        """Evict a resident tenant; refused (False) while a request pins
        it."""
        ent = self._resident.get(name)
        if ent is None:
            return False
        if ent["pins"] > 0:
            self.evict_denied += 1
            return False
        self._evict(name)
        return True

    # ------------------------------------------------------------ placement
    def place(self, mesh) -> Any:
        """Place the resident bank under ``mesh`` (a ``DeviceMesh``) by the
        adapter rule of ``launch.shardings.peft_shardings``: replicated.
        Each rank keeps a whole copy on the mesh's device (a replicated
        leaf's local tensor is the leaf), so the rows stay the tensors that
        ``load`` rewrites in place.  Returns the bank's specs."""
        from repro_torch.launch.shardings import peft_shardings

        if mesh is None or self._placed_mesh is mesh:
            return self.placement
        if any(t.device.type != mesh.device_type
               for t in _bank_tensors(self.tree)):
            raise ValueError(f"the pool's bank is not on the mesh's "
                             f"{mesh.device_type} device")
        self.placement = peft_shardings(mesh, self._bank)
        self._placed_mesh = mesh
        return self.placement

    # -------------------------------------------------------------- gauges
    def resident_nbytes(self) -> int:
        """Bytes of the resident bank (groups and id_maps): fixed by the
        capacity, not by the number of tenants."""
        return tree_nbytes(self.tree)

    def stats(self) -> Dict[str, Any]:
        return {
            "adapter_bytes_resident": self.resident_nbytes(),
            "adapter_bytes_registry": self.store.nbytes,
            "adapter_residents": self.num_resident,
            "adapter_capacity": self.capacity,
            "adapter_loads": self.loads,
            "adapter_evictions": self.evictions,
            "adapter_acquire_denied": self.acquire_denied,
            "adapter_evict_denied": self.evict_denied,
            "adapter_swap_p50": self.swap_hist.percentile(50),
            "adapter_swap_p99": self.swap_hist.percentile(99),
        }
