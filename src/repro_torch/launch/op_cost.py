"""Op-level cost counter: the port's counterpart of
``repro/launch/hlo_cost.py``.

The JAX package compiles a cell with XLA and parses the HLO text for
loop-aware FLOPs and bytes.  The port has no compiled program to parse:
its step runs eagerly, op by op.  So :class:`OpCost`, a
``TorchDispatchMode``, sees every aten op of a step run on the ``meta``
device (no memory, nothing on the card; or on the card itself, for the
same count of a real step) and records:

* the dot FLOPs by dtype, with ``torch.utils.flop_counter``'s formulas
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention);
* the bytes, as operands plus results: ``HloCostAnalysis``'s convention,
  which ``hlo_cost.py`` also takes.  Views, ``detach`` and metadata ops
  are free, as ``hlo_cost.py``'s bitcasts and reshapes are; an in-place
  write into part of a tensor (``copy_`` into a view, ``index_put_``,
  ``scatter_``: a ``dynamic-update-slice``) counts its update twice,
  read and written; a gather (``index``, ``embedding``) reads only the
  rows it takes;
* each collective's result bytes by kind, under the JAX package's five
  names (``c10d`` and ``_c10d_functional`` ops under a process group);
* the peak of live tensor bytes: the step's arguments (:meth:`hold`) plus
  its largest live set of the storages the step made, each counted from
  the op that made it until its storage dies, autograd's saved tensors
  included.  This is the counterpart of ``memory_analysis`` (JAX
  ``dryrun.py`` ``_mem_stats``).  ``hlo_cost.cpu_upcast_param_bytes``
  has none: it corrects for XLA:CPU's f32 copies of bf16 weights, and
  no such copies are made here.

``hlo_cost.py`` multiplies a ``while`` body by its trip count.  The
port's microbatch loop is Python and runs every trip, so a microbatched
train cell is counted at 2 and at 3 microbatches of the same rows and
extrapolated (:func:`affine`): its cost is affine in the microbatch
count from 2 on.

A kernel launch is a ``ctypes`` call, not an aten op: the counter cannot
see into it.  :func:`count` raises when a kernel launched while it
counted, so a program routed through a kernel raises instead of reading
low; the dry run runs the reference program and bills the kernels'
savings analytically (``launch/roofline.py``).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.roofline import COLLECTIVES

__all__ = ["OpCost", "count", "affine"]

aten = torch.ops.aten

# ops that move no bytes: metadata, aliases and allocations
_FREE = {aten.detach, aten.alias, aten.lift_fresh, aten._unsafe_view,
         aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.is_same_size, aten.sym_size,
         aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
         aten._local_scalar_dense, aten.set_, aten.resize_}
# in-place writes of part of their first operand: the update, read and
# written (``dynamic-update-slice``)
_SLICE_WRITES = {aten.copy_, aten.index_put_, aten._index_put_impl_,
                 aten.index_copy_, aten.index_add_, aten.scatter_,
                 aten.scatter_add_, aten.scatter_reduce_,
                 aten.masked_scatter_}
# gathers: the rows taken, read and written, and the indices
_GATHERS = {aten.index, aten.index_select, aten.embedding, aten.gather}


def _collective_ops() -> Dict[Any, str]:
    kinds = {}
    for ns, names in (
            ("c10d", {"allreduce_": "all-reduce",
                      "allgather_": "all-gather",
                      "_allgather_base_": "all-gather",
                      "allgather_into_tensor_coalesced_": "all-gather",
                      "reduce_scatter_": "reduce-scatter",
                      "_reduce_scatter_base_": "reduce-scatter",
                      "alltoall_": "all-to-all",
                      "alltoall_base_": "all-to-all",
                      "send": "collective-permute",
                      "recv_": "collective-permute"}),
            ("_c10d_functional", {
                "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"})):
        space = getattr(torch.ops, ns)
        for name, kind in names.items():
            try:
                kinds[getattr(space, name)] = kind
            except (AttributeError, RuntimeError):
                pass  # an op this torch build does not have
    return kinds


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors of ``tree`` in order: through dicts, lists, tuples and
    dataclasses (a ``TrainState``, its optimizer state, adapters)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _tensors(getattr(tree, f.name), out)
    return out


class OpCost(TorchDispatchMode):
    """Counts the aten ops run while it is active (see the module's
    docstring).  :meth:`hold` the step's arguments first, then run the
    step inside ``with``; :meth:`result` gives the counts."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.bytes = 0.0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._storages: Dict[int, tuple] = {}
        self._held: set = set()
        self._coll = _collective_ops()

    # -------------------------------------------------------- live bytes
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        # a storage's Python object lives as long as the storage itself
        # (PyTorch keeps it while any tensor, autograd's saved ones among
        # them, holds the storage), so its weakref fires when it dies
        self._storages[key] = (n, weakref.ref(st, self._dead(key)))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _dead(self, key: int) -> Callable:
        def gone(_ref, key=key, me=weakref.ref(self)):
            mode = me()
            if mode is not None and key in mode._storages:
                mode.live -= mode._storages.pop(key)[0]
        return gone

    def hold(self, *trees) -> None:
        """Count the tensors of ``trees`` (the step's arguments) as live
        from the start."""
        for t in _tensors(trees):
            key = t.untyped_storage()._cdata
            if key not in self._storages:
                self._track(t)
                self.argument_bytes += self._storages[key][0]
                self._held.add(key)

    def output_bytes(self, out) -> int:
        """Bytes of the storages in ``out`` that the step made."""
        seen = {}
        for t in _tensors(out):
            key = t.untyped_storage()._cdata
            if key not in self._held:
                seen[key] = t.untyped_storage().nbytes()
        return sum(seen.values())

    # ------------------------------------------------------------ counts
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        self.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            dt = str(ins[0].dtype)
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + f
        kind = self._coll.get(packet)
        if kind is not None:
            self.collectives[kind] += sum(_nbytes(t) for t in outs)
        if not (func.is_view or packet in _FREE):
            if packet in _SLICE_WRITES:
                self.bytes += 2 * sum(_nbytes(t) for t in ins[1:])
            elif packet in _GATHERS:
                idx = [t for t in ins[1:] if not t.is_floating_point()]
                self.bytes += (2 * sum(_nbytes(t) for t in outs)
                               + sum(_nbytes(t) for t in idx))
            else:
                self.bytes += (sum(_nbytes(t) for t in ins)
                               + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track(t)
        return out

    def result(self) -> Dict[str, Any]:
        return {
            "flops": float(sum(self.flops_by_dtype.values())),
            "flops_by_dtype": dict(self.flops_by_dtype),
            "bytes accessed": float(self.bytes),
            "collectives": dict(self.collectives),
            "peak_bytes": int(self.peak),
            "argument_bytes": int(self.argument_bytes),
            "ops": self.ops,
        }


def count(fn: Callable, *args) -> Dict[str, Any]:
    """``fn(*args)`` under :class:`OpCost`, ``args`` held as the step's
    arguments: :meth:`OpCost.result` plus ``output_bytes``.  Raises when
    a hand-written kernel launched meanwhile (its work is opaque to the
    counter)."""
    from repro_torch import kernels

    before = kernels.launch_counts()
    mode = OpCost()
    mode.hold(args)
    with mode:
        out = fn(*args)
    launched = {k: n - before[k] for k, n in kernels.launch_counts().items()
                if n != before[k]}
    if launched:
        raise RuntimeError(
            f"kernels launched while the op counter ran, their work "
            f"unseen: {launched}; count the reference program "
            f"(attn_backend and peft_backend 'reference')")
    res = mode.result()
    res["output_bytes"] = mode.output_bytes(out)
    del out
    return res


def affine(c2: Dict[str, Any], c3: Dict[str, Any], m: int
           ) -> Dict[str, Any]:
    """The counts at ``m`` microbatches from the counts at 2 and at 3 (the
    cost is affine in the microbatch count from 2 on): every number of
    the two results, nested dicts included, as ``c2 + (m - 2) * (c3 -
    c2)``."""
    def go(a, b):
        if isinstance(a, dict):
            return {k: go(a.get(k, 0), b.get(k, 0))
                    for k in sorted(set(a) | set(b))}
        return a + (m - 2) * (b - a)
    return go(c2, c3)
