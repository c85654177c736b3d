"""Multi-tenant adapter bank: N trained adapter sets over one base model
(port of ``repro/core/bank.py``).

Each request names its tenant; a batch mixing tenants is one model call.
Per-request global ids (0 = the base model, ``1 + i`` = ``names[i]``) are
a ``(B,)`` int32 tensor on the device, each adapted linear looks up its
rows in the ``id_maps`` on the device and applies each slot's adapter
(the multi-LoRA serving pattern).  Under the kernel backend LoRA groups go
through the banked-gather kernel (``kernels/banked_gather.py``); the
gather-then-``delta`` of ``Adapter.banked_delta`` is the reference.

Layout
------
Tenants may use different methods and ranks, so members are grouped per
adapted path by :func:`adapter_signature` (class, static fields, leaf
shapes and dtypes).  Per path and group the bank stores

* a bank-stacked adapter whose tensors carry a bank axis of extent
  ``G + 1``: row 0 is the group's neutral (``Adapter.neutral``, ``apply(x,
  w) == x @ w`` exactly), used for id 0 and for tenants of other groups;
* an ``id_map`` ``(n_tenants + 1,)`` int32 from global id to local row
  (0 when the tenant is not in the group).

For layer-stacked paths the bank axis sits at axis 1, ``(L, G+1, ...)``:
a layer view is a plain ``[i]`` and a tenant's rows are contiguous
per layer.  ``serve/adapter_pool.py`` keeps the same layout at a fixed
capacity and swaps rows in place.

Exactness
---------
Delta-form groups (LoRA, KronA, fold-free QuanTA) add their gathered
``delta(x)`` to the shared base product, neutral rows adding exact
zeros.  Non-delta groups (DoRA, DoTA, folded QuanTA wrapped in
``RebasedAdapter``) compute each bank row's full ``apply`` and
``torch.where``-select it over the base result for the slots on that
row, so no base product is added and taken away.

QuanTA tenants come in two forms.  Folded tenants come as the
``(params, adapter_set)`` pair ``attach`` returned: their trained delta
holds only against their own folded base ``W0 - S``, one dense ``(d_in,
d_out)`` copy per tenant per path.  Fold-free tenants
(``PeftConfig(fold=False)``) carry S as factor tensors and bank bare: a
tenant's resident cost is its factor tensors.  Under the kernel backend
their group's delta runs each slot's T and S chains through the chain
kernel (``QuantaAdapter.banked_delta``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.core.adapters import (
    Adapter, RebasedAdapter, base_matmul, structure, tree_leaves, tree_map,
    tree_nbytes,
)
from repro_torch.core.peft import AdapterSet, _set_path, flatten_paths

__all__ = [
    "AdapterBank",
    "BankedAdapter",
    "adapter_signature",
    "tenant_path_adapters",
]


@dataclasses.dataclass(frozen=True)
class _BankPath:
    """Bank storage of one adapted parameter path."""

    groups: Tuple[Any, ...]              # bank-stacked adapters, G_i + 1 rows
    id_maps: Tuple[torch.Tensor, ...]    # per group: (n_tenants + 1,) int32
    stacked: bool                        # bank axis at 1 behind the layers
    delta_forms: Tuple[bool, ...]

    def tensors(self):
        return tree_leaves(self.groups) + list(self.id_maps)


def _stack(entries, axis: int):
    return tree_map(lambda *ts: torch.stack(ts, axis), *entries)


def _stacked_layout(path: str, specs) -> bool:
    """Whether the path's members are layer-stacked (they must agree)."""
    specs = list(specs)
    if any(s.stacked != specs[0].stacked for s in specs):
        raise ValueError(f"path {path}: tenants disagree on stacked layout")
    return specs[0].stacked


def _bank_path(w0, stacked: bool, groups, n_ids: int, device,
               capacity: int = 0) -> _BankPath:
    """Bank storage of one path on ``device``.

    ``groups`` lists per group its prototype and its members as
    ``(global id, adapter)``.  Each group stacks its neutral as row 0 and
    its members as rows ``1..``, padded with neutral rows up to
    ``capacity`` (an ``AdapterPool``'s free rows); its ``id_map`` of
    ``n_ids`` entries sends each member's global id to its row and every
    other id to 0.
    """
    out, id_maps, dforms = [], [], []
    for proto, members in groups:
        neutral = tree_map(lambda t: t.to(device),
                           _neutral(proto, w0, stacked))
        rows = [neutral] + [a for _, a in members]
        rows += [neutral] * (capacity - len(members))
        out.append(_stack(rows, 1 if stacked else 0))
        idm = torch.zeros((n_ids,), dtype=torch.int32)
        for local, (gid, _) in enumerate(members, start=1):
            idm[gid] = local
        id_maps.append(idm.to(device))
        dforms.append(bool(proto.delta_form))
    return _BankPath(tuple(out), tuple(id_maps), stacked, tuple(dforms))


def _neutral(proto: Adapter, w0, stacked: bool) -> Adapter:
    """The group's neutral entry against the shared base (per layer for a
    layer-stacked path)."""
    if not stacked:
        return proto.neutral(w0)
    layer = getattr(w0, "layer", None)
    return _stack([proto.layer(i).neutral(layer(i) if layer else w0[i])
                   for i in range(w0.shape[0])], 0)


@dataclasses.dataclass(frozen=True)
class BankedAdapter(Adapter):
    """Per-request application of a bank path (the model-visible leaf).

    ``groups`` are bank-stacked adapters (for a layer-stacked path also
    layer-stacked, until ``layer(i)`` takes one layer), ``ids`` the
    per-slot local rows of each group, ``(B,)`` int32 on the device.
    """

    delta_form = False

    groups: Tuple[Any, ...]
    ids: Tuple[torch.Tensor, ...]
    delta_forms: Tuple[bool, ...]
    stacked: bool = False

    def layer(self, index: int) -> "BankedAdapter":
        if not self.stacked:
            return self
        return dataclasses.replace(
            self, groups=tuple(g.layer(index) for g in self.groups),
            stacked=False)

    def apply(self, x: torch.Tensor, w,
              backend: str = "reference") -> torch.Tensor:
        return self._select(x, w, backend, lambda g: g,
                            lambda a: a.apply(x, w, backend))

    def apply_cols(self, x: torch.Tensor, w, span,
                   backend: str = "reference") -> torch.Tensor:
        """A column-parallel shard: each delta-form group's columns
        ``span`` (LoRA multiplies by those columns of B), each non-delta
        row's ``apply_cols``."""
        return self._select(x, w, backend, lambda g: g.col_view(*span),
                            lambda a: a.apply_cols(x, w, span, backend))

    def _select(self, x, w, backend, view, full_of) -> torch.Tensor:
        # Under the kernel backend the first delta-form group may fuse the
        # shared base product with its gathered delta (banked_linear: the
        # banked-gather kernel for LoRA over a dense w); the other
        # delta-form groups add banked_delta.  Non-delta groups compute
        # each bank row's full apply and select it for that row's slots.
        y = None
        deferred = []
        for g, lid, dform in zip(self.groups, self.ids, self.delta_forms):
            if dform:
                g = view(g)
                if y is None and backend == "pallas":
                    y = g.banked_linear(x, w, lid, backend)
                    if y is not None:
                        continue
            deferred.append((g, lid, dform))
        if y is None:
            y = base_matmul(x, w, backend)
        for g, lid, dform in deferred:
            if dform:
                y = y + g.banked_delta(x, lid, backend)
                continue
            lid = lid.reshape((-1,) + (1,) * (y.dim() - 1))
            for row in range(1, tree_leaves(g)[0].shape[0]):
                full = full_of(tree_map(lambda t, r=row: t[r], g))
                y = torch.where(lid == row, full, y)
        return y

    def apply_rows(self, x: torch.Tensor, w, span, gathered,
                   backend: str = "reference"):
        """A row-parallel shard as ``(partial, post)``: LoRA groups go
        inside the partial sum (A's rows ``span``; under the kernel
        backend the first one fused with the base product), QuanTA groups
        after the reduction over the gathered input, and each non-delta
        row's own ``(partial, post)`` is selected for that row's slots."""
        partial, post, deferred = None, None, []
        for g, lid, dform in zip(self.groups, self.ids, self.delta_forms):
            if dform:
                rows = g.row_view(*span)
                if rows is None:
                    d = g.banked_delta(gathered(), lid, backend)
                    post = d if post is None else post + d
                    continue
                g = rows
                if partial is None and backend == "pallas":
                    partial = g.banked_linear(x, w, lid, backend)
                    if partial is not None:
                        continue
            deferred.append((g, lid, dform))
        if partial is None:
            partial = base_matmul(x, w, backend)
        for g, lid, dform in deferred:
            if dform:
                partial = partial + g.banked_delta(x, lid, backend)
                continue
            lid = lid.reshape((-1,) + (1,) * (partial.dim() - 1))
            for row in range(1, tree_leaves(g)[0].shape[0]):
                fp, fpost = tree_map(lambda t, r=row: t[r], g).apply_rows(
                    x, w, span, gathered, backend)
                partial = torch.where(lid == row, fp, partial)
                if fpost is not None or post is not None:
                    post = torch.where(
                        lid == row,
                        torch.zeros_like(post) if fpost is None else fpost,
                        torch.zeros_like(fpost) if post is None else post)
        return partial, post


TenantEntry = Union[AdapterSet, Tuple[Any, AdapterSet]]


def tenant_path_adapters(
    name: str, entry: TenantEntry
) -> Dict[str, Tuple[Adapter, Any]]:
    """One tenant as flat ``path -> (adapter, leaf_spec)``.

    Folded-QuanTA members are wrapped in :class:`RebasedAdapter` against
    the tenant's own folded base weight, which needs the ``(params,
    adapter_set)`` pair ``attach`` returned; fold-free members (the leaf
    spec's ``fold`` False) stay bare, delta-form over the shared base
    (given as a pair, the tenant's params are not read).  Shared by
    :meth:`AdapterBank.build` and ``serve.adapter_pool.AdapterStore``.
    """
    if isinstance(entry, tuple):
        t_params, aset = entry
        flat_t = flatten_paths(t_params)
    else:
        aset, flat_t = entry, None
    if not isinstance(aset, AdapterSet):
        raise TypeError(
            f"tenant {name!r}: expected an AdapterSet (or a (params, "
            f"AdapterSet) pair), got {type(aset).__name__}")
    specs = {s.path: s for s in aset.specs}
    out: Dict[str, Tuple[Adapter, Any]] = {}
    for path, adapter in aset.flat().items():
        spec = specs[path]
        if spec.method == "quanta" and getattr(spec, "fold", True):
            if flat_t is None:
                raise ValueError(
                    f"tenant {name!r} is folded QuanTA: attach folds the "
                    "frozen copy into the base weights, so the bank needs "
                    "the (params, adapter_set) pair attach returned to "
                    "rebase it onto the shared params (or retrain with "
                    "PeftConfig(fold=False) for factor-only residency)")
            adapter = RebasedAdapter(adapter, flat_t[path])
        out[path] = (adapter, spec)
    return out


def adapter_signature(adapter: Adapter):
    """Hashable grouping key of bank members: class and static fields
    (:func:`~repro_torch.core.adapters.structure`) plus leaf shapes and
    dtypes.  Members sharing it stack into one group."""
    return (structure(adapter),
            tuple((tuple(t.shape), str(t.dtype))
                  for t in tree_leaves(adapter)))


@dataclasses.dataclass(frozen=True)
class AdapterBank:
    """N tenants' adapters stacked for shared-base multi-tenant serving.

    Build with :meth:`build`; serve with ``ServingEngine(model,
    base_params, adapters=bank)`` and ``engine.submit(req,
    adapter="sst2")``.  ``subtree(key, adapter_ids)`` is the model-side
    entry point (through ``peft.adapter_subtree``).
    """

    tree: Dict[str, Any]               # nested dict of _BankPath
    names: Tuple[str, ...]

    @property
    def num_tenants(self) -> int:
        return len(self.names)

    def id_of(self, name: Optional[str]) -> int:
        """Global adapter id of a tenant (``None`` -> 0, the base)."""
        if name is None:
            return 0
        try:
            return 1 + self.names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown adapter {name!r}; bank serves {self.names}"
            ) from None

    def subtree(self, key: str, adapter_ids=None) -> Dict[str, Any]:
        """Nested tree of :class:`BankedAdapter` for one model group.

        ``adapter_ids`` are ``(B,)`` global ids; the lookup runs on the
        device of the ``id_maps`` (the ids are moved there once).  A bank
        cannot be applied without them.
        """
        sub = self.tree.get(key, {})
        if not sub:
            return {}
        if adapter_ids is None:
            raise ValueError(
                "AdapterBank needs per-request adapter_ids; this entry point "
                "does not thread them (training and forward paths serve "
                "single AdapterSets only)")
        ids = None

        def build(node):
            nonlocal ids
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            if ids is None:
                ids = torch.as_tensor(adapter_ids, dtype=torch.long,
                                      device=node.id_maps[0].device)
            return BankedAdapter(
                node.groups, tuple(m[ids] for m in node.id_maps),
                node.delta_forms, node.stacked)

        return build(sub)

    @property
    def nbytes(self) -> int:
        """Bytes of every bank tensor (groups and id_maps)."""
        return tree_nbytes(self.tree)

    def bank_axis_tree(self) -> "AdapterBank":
        """The bank with each tensor replaced by the index of its bank
        axis (1 behind the layers of a stacked path, else 0; -1 for the
        ``id_maps``): ``launch.shardings.peft_shardings(bank_dp=True)``
        reads it to split the bank axis over the DP axes."""
        def per(node):
            if isinstance(node, dict):
                return {k: per(v) for k, v in node.items()}
            ax = 1 if node.stacked else 0
            return dataclasses.replace(
                node,
                groups=tuple(tree_map(lambda _: ax, g)
                             for g in node.groups),
                id_maps=tuple(-1 for _ in node.id_maps))

        return dataclasses.replace(self, tree=per(self.tree))

    @staticmethod
    def build(base_params: Dict[str, Any],
              tenants: Mapping[str, TenantEntry]) -> "AdapterBank":
        """Pack trained tenants into a bank over ``base_params``.

        ``tenants`` maps a name to the tenant's :class:`AdapterSet` (LoRA,
        DoRA, DoTA, KronA: attach leaves the base as it is) or to the
        ``(params, adapter_set)`` pair ``attach`` returned (required for
        QuanTA).  Insertion order fixes the global ids: ``names[i]`` is
        id ``1 + i``.  The bank lives on the tenants' device.
        """
        names = tuple(tenants)
        flat_base = flatten_paths(base_params)
        per_path: Dict[str, list] = {}
        for t_idx, (name, entry) in enumerate(tenants.items()):
            for path, (adapter, spec) in tenant_path_adapters(
                    name, entry).items():
                per_path.setdefault(path, []).append((t_idx, adapter, spec))

        tree: Dict[str, Any] = {}
        for path, members in sorted(per_path.items()):
            stacked = _stacked_layout(path, (s for _, _, s in members))
            sigs: Dict[Any, list] = {}
            for t_idx, adapter, _ in members:
                sigs.setdefault(adapter_signature(adapter), []).append(
                    (1 + t_idx, adapter))
            groups = [(mems[0][1], mems) for mems in sigs.values()]
            device = tree_leaves(groups[0][0])[0].device
            _set_path(tree, path, _bank_path(
                flat_base[path], stacked, groups, len(names) + 1, device))
        return AdapterBank(tree=tree, names=names)
