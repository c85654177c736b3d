"""The JAX package's parameters, given as numpy arrays, as the port's
tensors.

The port keeps the JAX layouts (linears ``(d_in, d_out)``, layer-stacked
``(L, ...)`` leaves, QuanTA tensors ``(out_m, out_n, in_m, in_n)``), so
conversion is a plain copy.  Nothing here imports ``jax`` or ``repro``:
callers hand over nested dicts of arrays (anything ``numpy.asarray``
takes) and, for adapters, objects or dicts that carry the JAX adapter's
fields by name (QuanTA ``tensors``, ``dims_in``, ``dims_out``, ``pairs``;
LoRA ``a``, ``b``, ``alpha``; DoRA also ``m``; DoTA ``cores``, ``m``,
``dims_in``, ``dims_out``; KronA ``a``, ``b``, ``scale``; ``tree`` and
``specs`` for an adapter set, whose specs name each path's method).  A
quantized weight (an object with ``packed`` and ``scales``, as the JAX
``QuantizedLinear``) crosses as a plain copy of its codes, scales and
norms.  A fold-free QuanTA adapter carries its ``frozen`` copy S
across.  A bank is not converted: the port builds its own
(``core.bank.AdapterBank.build``) from tenants carried over with
:func:`tenant_from_numpy`.  :func:`train_state_from_numpy` carries a JAX
``TrainState`` (params, adapters, AdamW moments and step, error-feedback
residuals) into the port's, so that a run started in JAX goes on in the
port.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.baselines import (
    DoraAdapter, DotaAdapter, KronaAdapter, LoraAdapter,
)
from repro_torch.core.peft import (
    AdapterLeafSpec, AdapterSet, _set_path,
)
from repro_torch.core.quanta import QuantaAdapter
from repro_torch.core.quantize import QuantizedLinear
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compress import ErrorFeedbackState
from repro_torch.train.loop import TrainState

__all__ = ["tensor_from_numpy", "params_from_numpy", "quanta_from_numpy",
           "adapter_from_numpy", "adapter_set_from_numpy",
           "tenant_from_numpy", "quantized_linear_from_numpy",
           "train_state_from_numpy"]


def _field(obj, name, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One array as a tensor on ``device``.  bf16 arrays (numpy's
    ``bfloat16`` extension type) travel as their float32 values."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))   # owned, writable
    return t.to(device=device)


def quantized_linear_from_numpy(qw, device) -> QuantizedLinear:
    """A quantized weight (``packed``, ``scales``, ``fmt``, ``block_size``,
    ``dtype`` as a dtype name, optional ``row_norm``/``col_norm``)."""
    def opt(name):
        a = _field(qw, name)
        return None if a is None else tensor_from_numpy(a, device)

    return QuantizedLinear(
        packed=tensor_from_numpy(_field(qw, "packed"), device),
        scales=tensor_from_numpy(_field(qw, "scales"), device),
        fmt=str(_field(qw, "fmt")),
        block_size=_field(qw, "block_size"),
        dtype=getattr(torch, str(_field(qw, "dtype"))),
        row_norm=opt("row_norm"), col_norm=opt("col_norm"),
    )


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """A nested param dict of arrays (and quantized weights) as the port's
    param dict (stacked leaves stay stacked: the port keeps the JAX
    layout)."""
    def leaf(v):
        if isinstance(v, dict):
            return params_from_numpy(v, device)
        if _field(v, "packed") is not None:
            return quantized_linear_from_numpy(v, device)
        return tensor_from_numpy(v, device)

    return {k: leaf(v) for k, v in tree.items()}


def quanta_from_numpy(adapter, device) -> QuantaAdapter:
    """A QuanTA adapter (flat or layer-stacked), folded or fold-free (a
    ``frozen`` copy S)."""
    frozen = _field(adapter, "frozen")
    return QuantaAdapter(
        tuple(tensor_from_numpy(t, device)
              for t in _field(adapter, "tensors")),
        tuple(int(d) for d in _field(adapter, "dims_in")),
        tuple(int(d) for d in _field(adapter, "dims_out")),
        tuple((int(m), int(n)) for m, n in _field(adapter, "pairs")),
        frozen=None if frozen is None else tuple(
            tensor_from_numpy(t, device) for t in frozen),
    )


def adapter_from_numpy(adapter, method: str, device):
    """One adapter of ``method`` (quanta, lora, dora, dota, krona), flat
    or layer-stacked."""
    if method == "quanta":
        return quanta_from_numpy(adapter, device)

    def t(name):
        return tensor_from_numpy(_field(adapter, name), device)

    if method == "lora":
        return LoraAdapter(t("a"), t("b"), float(_field(adapter, "alpha")))
    if method == "dora":
        return DoraAdapter(t("a"), t("b"), t("m"),
                           float(_field(adapter, "alpha")))
    if method == "dota":
        return DotaAdapter(
            tuple(tensor_from_numpy(c, device)
                  for c in _field(adapter, "cores")), t("m"),
            tuple(int(d) for d in _field(adapter, "dims_in")),
            tuple(int(d) for d in _field(adapter, "dims_out")))
    if method == "krona":
        return KronaAdapter(t("a"), t("b"), float(_field(adapter, "scale")))
    raise ValueError(f"unknown PEFT method {method!r}")


def adapter_set_from_numpy(adapter_set, device) -> AdapterSet:
    """An adapter set: its ``tree`` of adapters, each converted by the
    method its spec names (QuanTA where there are no specs), and its
    ``specs``."""
    specs = tuple(
        AdapterLeafSpec(
            str(_field(s, "path")), str(_field(s, "method")),
            bool(_field(s, "stacked")), int(_field(s, "d_in")),
            int(_field(s, "d_out")), fold=bool(_field(s, "fold", True)),
        )
        for s in (_field(adapter_set, "specs") or ())
    )
    methods = {s.path: s.method for s in specs}
    tree: Dict[str, Any] = {}
    for path, a in _flat_adapters(_field(adapter_set, "tree")).items():
        _set_path(tree, path, adapter_from_numpy(
            a, methods.get(path, "quanta"), device))
    return AdapterSet(tree=tree, specs=specs)


def _flat_adapters(tree, prefix=""):
    """``path -> adapter`` of a nested dict whose adapters may themselves
    be dicts of fields."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and not {"tensors", "a", "cores"} & set(v):
            out.update(_flat_adapters(v, path))
        else:
            out[path] = v
    return out


def tenant_from_numpy(entry, device):
    """One bank tenant: an adapter set, or the ``(params, adapter_set)``
    pair of a folded QuanTA attach."""
    if isinstance(entry, tuple):
        params, aset = entry
        return (params_from_numpy(params, device),
                adapter_set_from_numpy(aset, device))
    return adapter_set_from_numpy(entry, device)


def train_state_from_numpy(state, device, *, full_ft: bool = False):
    """A JAX ``TrainState`` (``params``, ``peft``, ``opt_state`` with
    ``step``/``mu``/``nu``, ``ef_state`` or None, ``step``) as the port's
    ``train.loop.TrainState``.  The moments mirror the trainable tree: an
    adapter set for PEFT runs, the param dict under ``full_ft``."""
    def trainable(tree):
        if full_ft:
            return params_from_numpy(tree, device)
        return adapter_set_from_numpy(tree, device) if tree else {}

    opt = _field(state, "opt_state")
    ef = _field(state, "ef_state")
    peft = _field(state, "peft")
    return TrainState(
        params=params_from_numpy(_field(state, "params"), device),
        peft=adapter_set_from_numpy(peft, device) if peft else {},
        opt_state=AdamWState(step=int(np.asarray(_field(opt, "step"))),
                             mu=trainable(_field(opt, "mu")),
                             nu=trainable(_field(opt, "nu"))),
        ef_state=None if ef is None else ErrorFeedbackState(
            error=trainable(_field(ef, "error"))),
        step=int(np.asarray(_field(state, "step"))),
    )
