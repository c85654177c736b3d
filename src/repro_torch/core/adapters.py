"""The uniform ``Adapter`` protocol every PEFT method implements (port of
``repro/core/adapters.py``).

* ``apply(x, w, backend)`` -- the full adapted linear for weight ``w``;
  the default is the delta form ``x @ w + delta(x)``, weight-coupled
  methods (DoRA, DoTA) override it.
* ``delta(x)`` -- the additive update ``x @ dW`` in factored form (only
  meaningful when ``delta_form`` is True).
* ``matrix()`` -- the materialized ``(d_in, d_out)`` update.
* ``merge(w)`` -- deployment fold ``W = W0 + dW``, from ``matrix()``.
* ``neutral(w)`` -- a same-structure adapter whose ``apply(x, w)`` is
  exactly ``x @ w``: the all-zeros adapter for delta-form methods.  It is
  row 0 of a serving bank (``core/bank.py``).
* ``banked_delta`` / ``banked_linear`` -- application of a bank-stacked
  adapter (every tensor with a leading bank axis) with per-slot rows.
* ``num_params`` -- trainable parameter count.
* ``delta_form`` -- class flag: ``apply == x @ w + delta(x)``.
* ``apply_cols`` / ``apply_rows`` -- the adapted linear on one rank's
  shard of ``w`` under tensor parallelism over `model` (column-parallel:
  this rank's output columns; row-parallel: its input rows, as a partial
  sum plus what is added after the reduction); the adapter itself stays
  whole on every rank.  ``shardable`` says whether a method has them
  (LoRA, QuanTA); the others raise.

Adapters are frozen dataclasses.  Their tensor fields (and fields holding
tuples of tensors or nested adapters) are the leaves that :func:`tree_map`
walks; every other field is static.  Leaves may carry a leading layer
axis (one adapter per stacked ``(L, d_in, d_out)`` weight, ``layer(l)``
returns one layer's view) or a bank axis.  The frozen base ``w`` is a
dense tensor or a ``core.quantize.QuantizedLinear``; :func:`base_matmul`
takes both.

``RebasedAdapter`` pins a delta-form adapter to the base weight it was
trained against: QuanTA's attach folds the frozen copy into the base
(``W0' = W0 - S``), so a QuanTA tenant of a shared-base bank computes
``x @ W0'_tenant + delta(x)`` against its own stored base.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, List

import torch

from repro_torch.core.quantize import base_matmul

__all__ = ["Adapter", "ColumnSlice", "RebasedAdapter", "base_matmul",
           "tree_map", "tree_leaves", "tree_unflatten", "tree_nbytes",
           "structure", "unsharded_method"]


def _is_container(v) -> bool:
    """An adapter, or a dataclass that marks itself a tree node (an
    ``AdapterSet``): its tensor-holding fields are walked."""
    return isinstance(v, Adapter) or getattr(v, "tree_node", False)


def _is_node(v) -> bool:
    """A leaf tensor, an adapter, a dict, or a tuple holding any of them."""
    if isinstance(v, (torch.Tensor, dict)) or _is_container(v):
        return True
    return isinstance(v, tuple) and any(_is_node(e) for e in v)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (zipped with the same-structure
    ``rest``), rebuilding dicts, tuples and adapters; static fields are
    kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    if _is_container(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
            if _is_node(getattr(tree, f.name))
        })
    return tree


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in field order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves) -> Any:
    """``tree`` with its tensors replaced by ``leaves``, in the order of
    :func:`tree_leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a nested dict of tensors, adapters and
    objects with a ``tensors()`` method (a quantized weight's codes,
    scales and norms; a bank path's rows and id maps)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, Adapter):
        return sum(tree_nbytes(t) for t in tree_leaves(tree))
    if isinstance(tree, torch.Tensor):
        return int(tree.numel() * tree.element_size())
    tensors = getattr(tree, "tensors", None)
    return sum(tree_nbytes(t) for t in tensors()) if tensors else 0


def structure(tree) -> Any:
    """Hashable structure of ``tree``: classes, static fields and the
    positions of the tensors (which are left out)."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if isinstance(tree, tuple) and _is_node(tree):
        return tuple(structure(t) for t in tree)
    if isinstance(tree, Adapter):
        return (type(tree).__name__, tuple(
            (f.name, structure(getattr(tree, f.name)))
            for f in dataclasses.fields(tree)))
    return tree


def unsharded_method(adapter) -> str:
    """Why ``adapter`` cannot run on a `model` shard."""
    return (f"{type(adapter).__name__} is not served on a `model` shard: "
            "the port shards LoRA and QuanTA only (DoRA's and DoTA's column "
            "norms need a cross-rank reduction it does not have; DoRA, "
            "DoTA and KronA on shards are a ROADMAP item)")


class Adapter:
    """Protocol base class (mixin; concrete adapters are dataclasses)."""

    # True when apply(x, w) == x @ w + delta(x) with delta independent of w
    delta_form: ClassVar[bool] = True
    # True when the method runs on a `model` shard (apply_cols/apply_rows)
    shardable: ClassVar[bool] = False

    def delta(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a weight-independent "
            "delta; use apply(x, w)")

    def matrix(self) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} has no weight-independent update "
            "matrix; use merge(w)")

    def apply(self, x: torch.Tensor, w,
              backend: str = "reference") -> torch.Tensor:
        """Adapted linear ``x @ w + delta(x)`` (delta-form default); a
        quantized ``w`` goes through :func:`base_matmul`."""
        return base_matmul(x, w, backend) + self.delta(x)

    def merge(self, w: torch.Tensor) -> torch.Tensor:
        """Fold the trained update into the base weight (paper §6)."""
        m = self.matrix()
        return (w.to(m.dtype) + m).to(w.dtype)

    def neutral(self, w) -> "Adapter":
        """Same-structure adapter with ``apply(x, w) == x @ w`` exactly:
        the all-zeros adapter for delta-form methods (every update here
        is multilinear in its factors).  Weight-coupled methods
        override."""
        del w
        return tree_map(torch.zeros_like, self)

    # --- banked (multi-tenant) application ------------------------------
    # ``self`` is bank-stacked here: every tensor has a leading bank axis
    # of extent G+1 (row 0 neutral), and ``ids`` is a (B,) int32 tensor of
    # per-slot local rows on the tensors' device.

    def banked_delta(self, x: torch.Tensor, ids: torch.Tensor,
                     backend: str = "reference") -> torch.Tensor:
        """Per-slot gathered delta, the reference: gather each slot's
        row, then ``delta`` slot by slot.  Delta-form methods only."""
        del backend
        sel = tree_map(lambda leaf: leaf.index_select(0, ids), self)
        return torch.stack([
            tree_map(lambda leaf, b=b: leaf[b], sel).delta(x[b])
            for b in range(x.shape[0])
        ])

    def banked_linear(self, x: torch.Tensor, w, ids: torch.Tensor,
                      backend: str = "reference"):
        """``x @ w + banked_delta`` in one kernel, or ``None`` when the
        method has no fused path for these operands (the bank then adds
        ``banked_delta`` to a separate base product)."""
        del x, w, ids, backend
        return None

    # --- on a `model` shard ---------------------------------------------
    # ``span`` is ``(offset, n)``: this rank's block of W's output columns
    # (column-parallel) or of its input rows (row-parallel).

    def col_view(self, off: int, n: int) -> "Adapter":
        """A delta-form adapter whose ``delta`` is columns ``[off, off +
        n)`` of this one's."""
        raise ValueError(unsharded_method(self))

    def row_view(self, off: int, n: int):
        """A delta-form adapter whose ``delta`` of x's columns ``[off, off
        + n)`` is this rank's part of the partial sum, or None when the
        delta reads the whole input."""
        raise ValueError(unsharded_method(self))

    def apply_cols(self, x: torch.Tensor, w, span,
                   backend: str = "reference") -> torch.Tensor:
        """Columns ``span`` of ``apply(x, W)``, ``w`` those columns of W
        (a column-parallel shard; ``x`` whole)."""
        return self.col_view(*span).apply(x, w, backend)

    def apply_rows(self, x: torch.Tensor, w, span, gathered,
                   backend: str = "reference"):
        """A row-parallel shard: ``x`` holds the input's columns ``span``
        and ``w`` those rows of W.  Returns ``(partial, post)`` with
        ``apply(x_whole, W) == all_reduce(partial) + post`` (``post`` None
        when nothing follows the reduction); ``gathered()`` is the whole
        input (one ``all_gather`` a layer, made on first use)."""
        del gathered
        return self.row_view(*span).apply(x, w, backend), None

    @property
    def num_params(self) -> int:
        return sum(t.numel() for t in tree_leaves(self))

    def layer(self, index: int) -> "Adapter":
        """The adapter of one layer of a layer-stacked adapter (views)."""
        return tree_map(lambda t: t[index], self)


@dataclasses.dataclass(frozen=True)
class RebasedAdapter(Adapter):
    """An adapter pinned to the base weight it was trained against.

    ``apply(x, w)`` ignores the shared ``w`` and computes against the
    stored ``base``: exactly the single-tenant computation.  The bank
    wraps folded-QuanTA tenants in it (one dense ``(d_in, d_out)`` copy
    per tenant per path).  ``num_params`` counts the inner adapter only.
    """

    delta_form = False

    inner: Any
    base: torch.Tensor

    def apply(self, x: torch.Tensor, w,
              backend: str = "reference") -> torch.Tensor:
        del w
        return self.inner.apply(x, self.base, backend)

    def merge(self, w: torch.Tensor) -> torch.Tensor:
        del w
        return self.inner.merge(self.base)

    def neutral(self, w) -> "RebasedAdapter":
        """No-op inner adapter against the shared base ``w``."""
        return RebasedAdapter(self.inner.neutral(w), w)

    @property
    def num_params(self) -> int:
        return self.inner.num_params

    @property
    def shardable(self) -> bool:
        return self.inner.shardable

    def apply_cols(self, x: torch.Tensor, w, span,
                   backend: str = "reference") -> torch.Tensor:
        off, n = span
        return self.inner.apply_cols(x, self.base[..., off:off + n], span,
                                     backend)

    def apply_rows(self, x: torch.Tensor, w, span, gathered,
                   backend: str = "reference"):
        off, n = span
        return self.inner.apply_rows(x, self.base[..., off:off + n, :],
                                     span, gathered, backend)


@dataclasses.dataclass(frozen=True)
class ColumnSlice(Adapter):
    """Columns ``[off, off + n)`` of a bank group whose delta cannot be
    cut before it is computed (QuanTA's chain): the whole banked delta,
    then the slice."""

    inner: Any
    off: int
    n: int

    def banked_delta(self, x: torch.Tensor, ids: torch.Tensor,
                     backend: str = "reference") -> torch.Tensor:
        return self.inner.banked_delta(x, ids, backend)[
            ..., self.off:self.off + self.n]
