"""PEFT attachment layer (port of ``repro/core/peft.py``).

Models store every adaptable linear as ``(d_in, d_out)`` or, stacked over
layers, ``(L, d_in, d_out)``.  :func:`attach` builds an
:class:`AdapterSet` whose ``tree`` mirrors the parameter paths (adapters
stacked along the layer axis for stacked weights) for QuanTA, LoRA, DoRA,
DoTA or KronA; for QuanTA it also returns the base params with the frozen
copy folded in (``W0' = W0 - S``).  :func:`peft_linear` is the adapted
linear every model calls (:func:`sharded_linear` its form on one rank's
shard of the weight under tensor parallelism); :func:`merge_all` merges trained adapters into
the weights; :func:`adapter_subtree` gives a model group's adapters from
an ``AdapterSet`` or, with per-request ids, a serving bank
(``core/bank.py``).  ``PeftConfig(fold=False)`` attaches fold-free
QuanTA: the base is left as it is and each adapter carries its frozen
copy S (``core/quanta.py``).  :func:`trainable_fraction` is the paper's
"# Params (%)".
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, ClassVar, Dict, Optional, Tuple

import torch

from repro_torch.core import quanta as Q
from repro_torch.core.adapters import base_matmul, tree_map
from repro_torch.core.baselines import (
    DoraAdapter, DotaAdapter, KronaAdapter, LoraAdapter,
)
from repro_torch.core.factorize import factorize, pair_schedule, parse_scheme
from repro_torch.kernels.dispatch import default_device, seeded_generator

__all__ = [
    "PeftConfig",
    "AdapterLeafSpec",
    "AdapterSet",
    "choose_dims",
    "attach",
    "merge_all",
    "peft_linear",
    "sharded_linear",
    "adapter_subtree",
    "get_adapter",
    "layer_tree",
    "count_params",
    "trainable_fraction",
    "flatten_paths",
]

DEFAULT_TARGETS = (r".*/(q_proj|v_proj)$",)


@dataclasses.dataclass(frozen=True)
class PeftConfig:
    """Which method to attach, where, and with what hyperparameters."""

    method: str = "quanta"  # quanta | lora | dora | dota | krona | ft | none
    targets: Tuple[str, ...] = DEFAULT_TARGETS
    n_axes: int = 4
    scheme: Optional[str] = None          # e.g. "16-8-8-4"
    rounds: int = 1
    init: str = "identity_noise"
    noise_scale: float = 0.02
    fold: bool = True
    # LoRA / DoRA (DoTA: the bond rank)
    rank: int = 8
    alpha: float = 16.0
    # KronA
    krona_a: int = 64
    dtype: Any = torch.float32

    def replace(self, **kw) -> "PeftConfig":
        return dataclasses.replace(self, **kw)


def flatten_paths(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` of a nested dict (adapters are leaves)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_paths(v, path))
        else:
            out[path] = v
    return out


def _set_path(tree: Dict[str, Any], path: str, value: Any) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _copy_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of the dict structure sharing every leaf."""
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _match(path: str, patterns: Tuple[str, ...]) -> bool:
    return any(re.fullmatch(p, path) for p in patterns)


@dataclasses.dataclass(frozen=True)
class AdapterLeafSpec:
    """Static per-path record of what ``attach`` created."""

    path: str
    method: str
    stacked: bool
    d_in: int
    d_out: int
    fold: bool = True   # quanta only: False = fold-free (Eq. 8) attach


@dataclasses.dataclass(frozen=True)
class AdapterSet:
    """Adapters of one model: ``tree`` mirrors the parameter paths,
    ``specs`` records method and layout per adapted path.  It is a node of
    ``core.adapters.tree_map`` (the tensors of ``tree`` are its leaves), so
    the train step and the optimizer walk it like the JAX pytree."""

    tree_node: ClassVar[bool] = True

    tree: Dict[str, Any]
    specs: Tuple[AdapterLeafSpec, ...] = ()

    def subtree(self, key: str, adapter_ids=None) -> Dict[str, Any]:
        """The adapters under ``key``; ``adapter_ids`` is taken for the
        signature of ``AdapterBank.subtree`` and ignored (one set serves
        every request)."""
        del adapter_ids
        return self.tree.get(key, {})

    def __getitem__(self, key: str):
        return self.tree[key]

    def flat(self) -> Dict[str, Any]:
        return flatten_paths(self.tree)

    @property
    def paths(self) -> Tuple[str, ...]:
        return tuple(s.path for s in self.specs)

    @property
    def num_params(self) -> int:
        return count_params(self.tree)


def choose_dims(
    d_in: int, d_out: int, n_axes: int, scheme: Optional[str] = None
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """QuanTA axis factorizations for a (possibly rectangular) weight: the
    scheme or a balanced factorization when square; the simple ratio
    carried by axis 0 when rectangular (App. B)."""
    if d_in == d_out:
        dims = parse_scheme(scheme) if scheme else factorize(d_in, n_axes)
        if math.prod(dims) != d_in:
            raise ValueError(f"scheme {scheme} does not factor d={d_in}")
        return dims, dims
    g = math.gcd(d_in, d_out)
    p, q = d_in // g, d_out // g
    if d_in % p:
        raise ValueError(f"no simple-ratio factorization for {d_in}->{d_out}")
    base = factorize(d_in // p, n_axes)
    return (p * base[0],) + base[1:], (q * base[0],) + base[1:]


def _krona_dims(cfg: PeftConfig, d_in: int, d_out: int) -> Tuple[int, int]:
    """KronA factor dims; a pick that collapses to 1 raises."""
    a_in = math.gcd(cfg.krona_a, d_in)
    a_out = math.gcd(a_in, d_out)
    if a_in < 2 or a_out < 2:
        raise ValueError(
            f"krona_a={cfg.krona_a} is incompatible with a ({d_in}, {d_out}) "
            f"weight: the usable factor collapses to (a_in={a_in}, "
            f"a_out={a_out}), a near-empty adapter. Pick a krona_a sharing "
            f"a common divisor >= 2 with both dims (e.g. a divisor of "
            f"gcd={math.gcd(d_in, d_out)}).")
    return a_in, a_out


def _make_adapter(gen: torch.Generator, w: torch.Tensor, cfg: PeftConfig,
                  device):
    """One adapter for weight ``w``; layer-stacked (one per layer, drawn in
    layer order) for 3-D ``w``."""
    d_in, d_out = w.shape[-2], w.shape[-1]
    kw = dict(dtype=cfg.dtype, device=device)

    def make_one(w_layer):
        if cfg.method == "quanta":
            dims_in, dims_out = choose_dims(d_in, d_out, cfg.n_axes,
                                            cfg.scheme)
            return Q.QuantaAdapter.create(
                gen, d_in, d_out, n_axes=cfg.n_axes, dims_in=dims_in,
                dims_out=dims_out,
                pairs=pair_schedule(len(dims_in)) * cfg.rounds,
                init=cfg.init, noise_scale=cfg.noise_scale, **kw)
        if cfg.method == "lora":
            return LoraAdapter.create(gen, d_in, d_out, rank=cfg.rank,
                                      alpha=cfg.alpha, **kw)
        if cfg.method == "dora":
            # per-layer magnitude: each layer starts at the base model
            return DoraAdapter.create(gen, w_layer.to(cfg.dtype),
                                      rank=cfg.rank, alpha=cfg.alpha, **kw)
        if cfg.method == "dota":
            return DotaAdapter.create(gen, w_layer.to(cfg.dtype),
                                      rank=cfg.rank, n_axes=cfg.n_axes, **kw)
        if cfg.method == "krona":
            a_in, a_out = _krona_dims(cfg, d_in, d_out)
            return KronaAdapter.create(gen, d_in, d_out, a_in=a_in,
                                       a_out=a_out, **kw)
        raise ValueError(f"unknown PEFT method {cfg.method!r}")

    if w.dim() == 2:
        return make_one(w)
    layers = [make_one(w[i]) for i in range(w.shape[0])]
    return tree_map(lambda *ts: torch.stack(ts), *layers)


def _per_layer(fn, w: torch.Tensor, adapter) -> torch.Tensor:
    """``fn(w, adapter)`` for a flat weight, layer by layer for a stacked
    one (the JAX package's ``vmap``)."""
    if w.dim() == 3:
        return torch.stack([fn(w[i], adapter.layer(i))
                            for i in range(w.shape[0])])
    return fn(w, adapter)


def attach(
    seed, params: Dict[str, Any], cfg: PeftConfig, *, device=None
) -> Tuple[Dict[str, Any], Any]:
    """Create adapters for every parameter path matching ``cfg.targets``.

    ``seed`` is an int or a ``torch.Generator`` on ``device``.  Returns
    ``(base_params, adapter_set)``.  For QuanTA with ``cfg.fold`` the
    adapted base weights are ``W0 - S`` (the model is exactly the base
    model at step 0); with ``fold=False`` the base is returned as it is
    and each adapter carries a copy of its initial tensors as S.  The
    other methods start at a zero update and leave the base as it is.
    Runs on the card unless ``device`` says otherwise.
    """
    device = default_device(device)
    if cfg.method in ("ft", "none"):
        return params, {}
    gen = seeded_generator(seed, device)
    flat = flatten_paths(params)
    targets = {p: w for p, w in flat.items() if _match(p, cfg.targets)}
    if not targets:
        raise ValueError(
            f"no parameter matched targets {cfg.targets}; available paths: "
            f"{sorted(flat)[:20]}..."
        )
    peft: Dict[str, Any] = {}
    specs = []
    new_params = _copy_tree(params)
    for path, w in sorted(targets.items()):
        if w.dim() not in (2, 3):
            raise ValueError(f"target {path} has ndim={w.dim()}; expected 2 or 3")
        adapter = _make_adapter(gen, w, cfg, device)
        if cfg.method == "quanta" and not cfg.fold:
            # S is a copy: training or perturbing T in place leaves it
            adapter = dataclasses.replace(
                adapter, frozen=tuple(t.clone() for t in adapter.tensors))
        _set_path(peft, path, adapter)
        specs.append(AdapterLeafSpec(
            path, cfg.method, w.dim() == 3, w.shape[-2], w.shape[-1],
            fold=cfg.fold,
        ))
        if cfg.method == "quanta" and cfg.fold:
            _set_path(new_params, path,
                      _per_layer(Q.fold_frozen_copy, w, adapter))
    return new_params, AdapterSet(tree=peft, specs=tuple(specs))


def adapter_subtree(peft, key: str, adapter_ids=None) -> Dict[str, Any]:
    """The nested adapter tree of one model group: ``peft`` is ``None``, a
    bare dict, an :class:`AdapterSet` or an ``AdapterBank`` /
    ``AdapterPool`` bank, for which ``adapter_ids`` (``(B,)`` global
    tenant ids, 0 = the base model) select each request's adapter."""
    if peft is None:
        return {}
    sub = getattr(peft, "subtree", None)
    if sub is not None:
        return sub(key, adapter_ids)
    return peft.get(key, {})


def layer_tree(tree: Dict[str, Any], index: int) -> Dict[str, Any]:
    """Layer ``index`` of a nested dict of layer-stacked tensors and
    adapters (views, no copies)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = layer_tree(v, index)
        elif isinstance(v, torch.Tensor):
            out[k] = v[index]
        else:
            out[k] = v.layer(index)
    return out


def get_adapter(peft: Optional[Dict[str, Any]], *keys: str):
    """Walk the adapter tree; None when the path is not adapted."""
    node = peft
    for k in keys:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node if not isinstance(node, dict) else None


def peft_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    adapter=None,
    bias: Optional[torch.Tensor] = None,
    backend: str = "reference",
) -> torch.Tensor:
    """The adapted linear of every model: ``adapter.apply`` (protocol
    dispatch) or ``x @ w``, plus the bias."""
    y = (base_matmul(x, w, backend) if adapter is None
         else adapter.apply(x, w, backend))
    if bias is not None:
        y = y + bias
    return y


def sharded_linear(
    x: torch.Tensor,
    w,
    adapter,
    bias: Optional[torch.Tensor],
    backend: str,
    tp,
    kind: str,
) -> torch.Tensor:
    """:func:`peft_linear` on this rank's shard of ``w`` (``tp``: a
    ``models.tensor_parallel.ModelGroup``), Megatron style.

    * ``kind="col"`` (column-parallel): ``x`` whole, ``w`` and ``bias``
      this rank's output columns; the result is those columns.
    * ``kind="row"`` (row-parallel): ``x`` this rank's input columns and
      ``w`` those rows; the partial products are summed over the group
      (one ``all_reduce``) and the adapter's part that reads the whole
      input (QuanTA's chain, on one ``all_gather`` of ``x``) is added
      after it.  The result is whole on every rank.
    """
    if kind == "col":
        span = tp.span(w.shape[-1])
        y = (base_matmul(x, w, backend) if adapter is None
             else adapter.apply_cols(x, w, span, backend))
    elif kind == "row":
        if adapter is None:
            y = tp.all_reduce(base_matmul(x, w, backend))
        else:
            whole = []

            def gathered():
                if not whole:
                    whole.append(tp.all_gather(x))
                return whole[0]

            partial, post = adapter.apply_rows(x, w, tp.span(x.shape[-1]),
                                               gathered, backend)
            y = tp.all_reduce(partial)
            if post is not None:
                y = y + post
    else:
        raise ValueError(f"unknown shard kind {kind!r}")
    return y if bias is None else y + bias


def merge_all(params: Dict[str, Any], peft) -> Dict[str, Any]:
    """Merge every adapter into the base weights (the deployment form,
    §6).  Unadapted leaves are shared with ``params``, not copied."""
    flat_adapters = flatten_paths(getattr(peft, "tree", peft) or {})
    flat_params = flatten_paths(params)
    merged = _copy_tree(params)
    for path, adapter in flat_adapters.items():
        _set_path(merged, path, _per_layer(
            lambda w, a: a.merge(w), flat_params[path], adapter
        ))
    return merged


def count_params(tree: Any) -> int:
    """Parameters of a param tree or adapter set; an adapter counts its
    trainable tensors (``num_params``: a fold-free QuanTA adapter leaves
    out S, where the JAX package's ``count_params`` counts every leaf)."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    return tree.num_params


def trainable_fraction(base_params: Any, peft: Any) -> float:
    """Paper-style ``# Params (%)``: trainable over base totals."""
    return 100.0 * count_params(peft) / max(count_params(base_params), 1)

