"""Sharding rules (port of ``repro/launch/shardings.py``): parameter,
adapter, batch, cache and train-state placement, and their DTensor
placements on a ``DeviceMesh``.

The rules are the JAX package's, copied: regular expressions over a
leaf's path (dict keys, dataclass field names and sequence indices joined
by ``/``, as the JAX package formats its key paths) to a template of mesh
axes for the leaf's TRAILING dims, with a dim that the axis does not
divide left unsharded.

* **TP over `model`** -- column-parallel in-projections, row-parallel
  out-projections, the vocab-sharded embedding and LM head (a decode
  placement shards the table on d_model instead).
* **DP over `(pod, data)`** -- batch dims; adapters and norms replicated.
* **EP** -- MoE expert stacks shard the expert axis over `model` when
  ``E % 16 == 0``, else each expert's ``d_ff``; ``cfg.fsdp`` also shards
  the expert stacks' ``d_ff`` over `data`.
* **Caches** -- the slot axis over DP when it divides; KV heads or
  head_dim over `model`; ``seq_shard`` splits the sequence instead.
  Paged pools shard their block axis over DP (one arena a data shard,
  ``serve/paging.py``; gated on ``pool_data_shards``), never the
  ``block_size`` axis.

Every function returns a tree of :class:`PartitionSpec` that mirrors its
input: one spec a leaf, one entry a dim, each a mesh axis name, a tuple
of names (the dim split over their flattened sub-mesh) or ``None``.
:func:`placements` turns a spec into DTensor placements (``Shard(d)`` /
``Replicate()``) on a ``DeviceMesh`` and :func:`distribute_tree` places a
tree by its specs.  The rules take an ``AbstractMesh``
(``launch/mesh.py``) or a ``DeviceMesh``.  :func:`local_params` is one
rank's share of a parameter tree under the decode rules, as plain local
tensors: what the tensor-parallel forward (``models/tensor_parallel.py``)
runs on.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.launch.mesh import (
    axis_sizes, dp_axes, dp_size, mesh_coordinate,
)
from repro_torch.models.common import ModelConfig, PagedCacheLeafSpec

__all__ = [
    "P", "PartitionSpec", "param_shardings", "batch_shardings",
    "cache_shardings", "peft_shardings", "replicated", "state_shardings",
    "placements", "local_shape", "distribute_tree", "placed_zeros",
    "map_with_paths", "local_params", "row_blocks",
]


class PartitionSpec(tuple):
    """Per-dim mesh axes of one leaf: ``PartitionSpec(None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


# ----------------------------------------------------------------- trees
def _holds(v) -> bool:
    """Whether ``v`` holds a leaf (a tensor, or an int leaf of a
    dataclass that names it in ``int_leaves``)."""
    if isinstance(v, torch.Tensor):
        return True
    if isinstance(v, dict):
        return any(_holds(e) for e in v.values())
    if isinstance(v, (tuple, list)):
        return any(_holds(e) for e in v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return bool(getattr(v, "int_leaves", ())) or any(
            _holds(getattr(v, f.name)) for f in dataclasses.fields(v))
    return False


def map_with_paths(fn: Callable, tree: Any, *rest: Any,
                   path: Tuple[str, ...] = ()) -> Any:
    """``tree`` rebuilt with ``fn(path, leaf, *rest_leaves)`` at every
    leaf: tensors, and the int fields a dataclass names in
    ``int_leaves``.  ``path`` is the tuple of dict keys, field names and
    sequence indices; ``rest`` are trees of the same structure whose
    entries at the leaf positions may be anything.  Dataclasses are
    copied with their leaf fields replaced (no ``__init__`` runs)."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, *(r[k] for r in rest),
                                  path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and _holds(tree):
        return type(tree)(
            map_with_paths(fn, v, *(r[i] for r in rest),
                           path=path + (str(i),))
            for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type) \
            and _holds(tree):
        ints = getattr(tree, "int_leaves", ())
        out = copy.copy(tree)
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            rs = [getattr(r, f.name) for r in rest]
            if f.name in ints:
                new = fn(path + (f.name,), v, *rs)
            elif _holds(v):
                new = map_with_paths(fn, v, *rs, path=path + (f.name,))
            else:
                continue
            object.__setattr__(out, f.name, new)
        return out
    return tree


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def replicated(mesh, tree: Any) -> Any:
    return map_with_paths(lambda *_: P(), tree)


# ----------------------------------------------------------------- rules
_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "rec_proj",
        "z_proj", "x_proj", "bc_proj", "dt_proj", "w_a", "w_x")
_ROW = ("o_proj", "down_proj", "out_proj")


def _rules(cfg: ModelConfig, decode: bool = False):
    expert_parallel = cfg.is_moe and cfg.n_experts % 16 == 0
    rules = []
    if decode:
        # serving shards the table on d_model: token gathers stay local
        rules.append((r".*embed/tokens$", (None, "model")))
    if cfg.is_moe:
        if expert_parallel:
            ff_spec = "data" if cfg.fsdp else None
            rules += [
                (r".*/moe/(gate_proj|up_proj)$", ("model", None, ff_spec)),
                (r".*/moe/down_proj$", ("model", ff_spec, None)),
                (r".*/moe/router$", (None, "model")),
            ]
        else:
            rules += [
                (r".*/moe/(gate_proj|up_proj)$", (None, None, "model")),
                (r".*/moe/down_proj$", (None, "model", None)),
                (r".*/moe/router$", (None, None)),
            ]
    rules += [
        # a quantized projection's codes keep the weight's layout on their
        # trailing dims; its scales follow its d_out / d_in axis
        (r".*/(%s)/(packed|scales)$" % "|".join(_COL), (None, "model")),
        (r".*/(%s)/col_norm$" % "|".join(_COL), ("model",)),
        (r".*/(%s)/(packed|scales)$" % "|".join(_ROW), ("model", None)),
        (r".*/(%s)/row_norm$" % "|".join(_ROW), ("model",)),
        (r".*/(%s)$" % "|".join(_COL), (None, "model")),
        (r".*/(%s)$" % "|".join(_ROW), ("model", None)),
        (r".*/(q_bias|k_bias|v_bias)$", ("model",)),
        (r".*embed/tokens$", ("model", None)),
        (r".*lm_head$", (None, "model")),
        (r".*/conv_w$", (None, "model")),
        (r".*/conv_b$", ("model",)),
    ]
    return rules


def _apply_trailing(mesh, shape: Tuple[int, ...],
                    trailing: Tuple[Optional[str], ...]) -> PartitionSpec:
    """Leading dims ``None``, trailing dims per template; a dim the axis
    does not divide stays ``None``."""
    spec: list = [None] * len(shape)
    k = len(trailing)
    if k > len(shape):
        trailing = trailing[k - len(shape):]
        k = len(trailing)
    sizes = axis_sizes(mesh)
    for i, ax in enumerate(trailing):
        dim = len(shape) - k + i
        if ax is None:
            continue
        if shape[dim] % sizes.get(ax, 1) == 0:
            spec[dim] = ax
    return P(*spec)


def peft_shardings(mesh, peft: Any, bank_dp: bool = False) -> Any:
    """Adapter state: replicated (PEFT state is tiny, and per-slot tenant
    ids may need any bank row on any device).  ``bank_dp=True`` shards an
    ``AdapterBank``'s bank axis over the DP axes where the extent divides
    (``AdapterBank.bank_axis_tree``); id maps and other leaves stay
    replicated."""
    axes = getattr(peft, "bank_axis_tree", None)
    if not bank_dp or axes is None:
        return replicated(mesh, peft)
    dp = dp_axes(mesh)
    size = dp_size(mesh)

    def assign(_, leaf, ax):
        shape = _shape(leaf)
        if size > 1 and ax >= 0 and len(shape) > ax \
                and shape[ax] % size == 0:
            spec: list = [None] * len(shape)
            spec[ax] = dp
            return P(*spec)
        return P()

    return map_with_paths(assign, peft, axes())


def param_shardings(cfg: ModelConfig, mesh, params_tree: Any,
                    decode: bool = False) -> Any:
    """One spec a leaf of ``params_tree`` (tensors, ``meta`` or not)."""
    rules = _rules(cfg, decode=decode)

    def assign(path, leaf):
        name = "/".join(path)
        for pattern, trailing in rules:
            if re.fullmatch(pattern, name):
                return _apply_trailing(mesh, _shape(leaf), trailing)
        return P()               # norms, scalars, small vectors: replicate

    return map_with_paths(assign, params_tree)


def batch_shardings(mesh, batch_tree: Any) -> Any:
    """The batch dim over the DP axes, where it divides."""
    dp = dp_axes(mesh)
    size = dp_size(mesh)

    def assign(_, leaf):
        shape = _shape(leaf)
        if not shape or shape[0] % size != 0:
            return P()
        return P(dp, *([None] * (len(shape) - 1)))

    return map_with_paths(assign, batch_tree)


def cache_shardings(cfg: ModelConfig, mesh, cache_tree: Any,
                    seq_shard: bool = False, spec: Any = None,
                    paged: bool = False,
                    pool_data_shards: Optional[int] = None) -> Any:
    """Decode caches: the batch (slot) dim over DP, KV heads or head_dim
    over `model`.  ``seq_shard`` splits a ``(L, B, S, KV, hd)`` K/V cache's
    sequence over `model` instead.  With the model's ``cache_spec()`` as
    ``spec`` and ``paged=True``, a ``PagedCacheLeafSpec`` leaf is a pool:
    its block axis over DP (only when ``pool_data_shards`` is ``None`` or
    the DP size: the allocator's arenas must match), never its
    ``block_size`` axis, and `model` on a dim past it."""
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    size = dp_size(mesh)
    model_size = sizes.get("model", 1)
    has_model = "model" in sizes

    def pool_assign(ls: PagedCacheLeafSpec, shape) -> PartitionSpec:
        pspec: list = [None] * len(shape)
        if dp and shape[ls.slot_axis] % size == 0 and \
                (pool_data_shards is None or pool_data_shards == size):
            pspec[ls.slot_axis] = dp
        for dim in range(len(shape) - 1, ls.page_axis, -1):
            if has_model and shape[dim] % model_size == 0 and \
                    shape[dim] >= model_size:
                pspec[dim] = "model"
                break
        return P(*pspec)

    def assign(path, leaf, leaf_spec=None):
        if paged and isinstance(leaf_spec, PagedCacheLeafSpec):
            return pool_assign(leaf_spec, _shape(leaf))
        name = "/".join(path)
        shape = _shape(leaf)
        spec_: list = [None] * len(shape)
        # caches are (L, B, ...) except tail_* and len, which are (B, ...)
        b_dim = 0 if (name.startswith("tail_") or name == "len") else 1
        if len(shape) > b_dim and shape[b_dim] % size == 0 and dp:
            spec_[b_dim] = dp
        if seq_shard and name in ("k", "v") and len(shape) == 5 and \
                shape[2] % model_size == 0:
            spec_[2] = "model"                  # (L, B, S, KV, hd): split S
            return P(*spec_)
        for dim in range(len(shape) - 1, b_dim, -1):
            if spec_[dim] is None and shape[dim] % model_size == 0 and \
                    shape[dim] >= model_size and name != "len" and \
                    "pos" not in name:
                spec_[dim] = "model"
                break
        return P(*spec_)

    if spec is not None:
        return map_with_paths(assign, cache_tree, spec)
    return map_with_paths(assign, cache_tree)


def state_shardings(cfg: ModelConfig, mesh, state_tree: Any,
                    decode: bool = False) -> Any:
    """A ``TrainState``'s specs: base params per the rules, everything
    else (adapters, optimizer moments, error feedback, step) replicated."""
    from repro_torch.train.loop import TrainState

    return TrainState(
        params=param_shardings(cfg, mesh, state_tree.params, decode=decode),
        peft=replicated(mesh, state_tree.peft),
        opt_state=replicated(mesh, state_tree.opt_state),
        ef_state=replicated(mesh, state_tree.ef_state),
        step=P(),
    )


# ------------------------------------------------------------ placements
def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: PartitionSpec):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that splits tensor dim ``d``, ``Replicate()`` elsewhere.  A
    dim split over a tuple of axes takes them in mesh order (the first
    the major one), as a flattened sub-mesh."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of mesh order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape: Tuple[int, ...], spec: PartitionSpec,
                mesh) -> Tuple[int, ...]:
    """The shape one rank holds of a ``shape`` leaf placed by ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        out[d] //= n
    return tuple(out)


def distribute_tree(tree: Any, mesh, specs: Any) -> Any:
    """``tree`` as DTensors placed by ``specs`` (a tree of the same
    structure).  Every rank must hold the same full leaves (weights made
    from one seed): each keeps its own shard, and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    def one(_, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, placements(mesh, spec),
                                 src_data_rank=None)

    return map_with_paths(one, tree, specs)


def placed_zeros(struct: Any, mesh, specs: Any, device) -> Any:
    """Zero DTensors of the ``meta`` tensors in ``struct``, placed by
    ``specs``: each rank allocates its own shard only."""
    from torch.distributed.tensor import DTensor

    def one(_, leaf, spec):
        local = torch.zeros(local_shape(tuple(leaf.shape), spec, mesh),
                            dtype=leaf.dtype, device=device)
        return DTensor.from_local(local, mesh, placements(mesh, spec),
                                  run_check=False, shape=leaf.shape,
                                  stride=torch.empty(leaf.shape,
                                                     device="meta").stride())

    return map_with_paths(one, struct, specs)


# ------------------------------------------------------- a rank's shards
def row_blocks(d_in: int, block_size: int, m: int, rank: int
               ) -> Tuple[int, int, int, int]:
    """``(off, n, lo, hi)``: rank ``rank``'s rows ``[off, off + n)`` of a
    row-parallel quantized weight split ``m`` ways, and the quant blocks
    ``[lo, hi)`` they read.  Each local block must be one whole block of
    the weight (the shard starts on a block boundary, or lies inside one
    block: its rows then read that block's scale) and ``n`` a multiple of
    8 (the kernel's K step); raises otherwise."""
    if d_in % m:
        raise ValueError(f"model={m} does not divide d_in {d_in}")
    n = d_in // m
    off = rank * n
    lo, hi = off // block_size, -(-(off + n) // block_size)
    if n % 8 or (off % block_size and hi - lo != 1):
        raise ValueError(
            f"a row shard of {n} of {d_in} rows in quant blocks of "
            f"{block_size} does not map onto whole blocks (rows "
            f"[{off}, {off + n})): the local d_in must be a multiple of 8 "
            f"and start on a block boundary or lie inside one block")
    return off, n, lo, hi


def local_params(cfg: ModelConfig, mesh, params: Any, device=None,
                 base_quant: Optional[str] = None,
                 block_size: int = 64) -> Any:
    """This rank's share of ``params`` under ``param_shardings(cfg, mesh,
    params, decode=True)`` on its `model` coordinate, as plain tensors on
    ``device`` (default: each leaf's own).

    A leaf the rule shards over `model` keeps this rank's block
    (``local_shape``), sliced where it lies (on the host for host
    params) and copied fresh, so nothing of the whole leaf stays held;
    every other leaf is kept whole.  A DTensor (``checkpoint.store
    .restore_resharded`` with the same specs) must be placed by those
    specs and gives its local tensor as it is.  A row-parallel quantized
    projection whose block axis the rule left whole (the blocks do not
    divide) keeps the scales of the blocks its rows read
    (:func:`row_blocks`).  ``base_quant`` packs every dense projection of
    ``core.quantize.QUANT_TARGETS`` on the device from its shard, each
    row shard from the whole blocks it reads, so the codes and scales
    are those of the whole weight quantized, sliced."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.quantize import (
        QUANT_TARGETS, QuantizedLinear, quantize_linear,
    )

    specs = param_shardings(cfg, mesh, params, decode=True)
    m = axis_sizes(mesh).get("model", 1)
    r = mesh_coordinate(mesh)["model"] if m > 1 else 0

    def take(t, spec):
        if isinstance(t, DTensor):
            if list(t.placements) != placements(mesh, spec):
                raise ValueError(f"a leaf placed as {list(t.placements)} "
                                 f"where the decode rule says {spec}")
            return t.to_local()
        for d, entry in enumerate(spec):
            if "model" in _axes(entry):
                n = t.shape[d] // m
                t = t.narrow(d, r * n, n)
        return t

    def fresh(t):
        dev = t.device if device is None else device
        return torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t)

    def place(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        local = take(t, spec)
        split = tuple(local.shape) != tuple(t.shape)
        return fresh(local) if split else (
            local if device is None else local.to(device))

    def quantized(name, w, spec, row):
        """A dense projection packed from this rank's shard."""
        if not row:
            return quantize_linear(fresh(take(w, spec)), base_quant,
                                   block_size=block_size)
        d_in = w.shape[-2]
        off, n, lo, hi = row_blocks(d_in, block_size, m, r)
        a, b = lo * block_size, min(hi * block_size, d_in)
        if isinstance(w, DTensor):
            if (a, b) != (off, off + n):
                raise ValueError(
                    f"{name}: a placed row shard that reads part of a quant "
                    "block cannot be packed alone; pack it before placing")
            rows = take(w, spec)
        else:
            rows = w.narrow(-2, a, b - a)
        q = quantize_linear(fresh(rows), base_quant, block_size=block_size)
        cut = off - a
        per = 2 if base_quant == "nf4" else 1
        return dataclasses.replace(
            q, packed=q.packed.narrow(-2, cut // per, n // per).contiguous())

    def packed_leaf(name, qw, spec, row):
        """An already packed projection: its shards by the rule, the
        scales of a row shard by the blocks its rows read."""
        out = map_with_paths(lambda _, t, sp: place(t, sp), qw, spec)
        if row and not any("model" in _axes(e) for e in spec.scales):
            _, _, lo, hi = row_blocks(qw.d_in, qw.block_size or qw.d_in,
                                      m, r)
            scales = take(qw.scales, spec.scales)
            out = dataclasses.replace(out, scales=fresh(
                scales.narrow(-2, lo, hi - lo)))
        elif row:
            row_blocks(qw.d_in, qw.block_size or qw.d_in, m, r)
        return out

    def walk(node, spec, path):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], path + (k,))
                    for k, v in node.items()}
        name = path[-1] if path else ""
        row = name in _ROW
        if isinstance(node, QuantizedLinear):
            return packed_leaf("/".join(path), node, spec, row)
        if (base_quant is not None and name in QUANT_TARGETS
                and isinstance(node, torch.Tensor) and node.dim() in (2, 3)):
            return quantized("/".join(path), node, spec, row)
        return place(node, spec)

    return walk(params, specs, ())
