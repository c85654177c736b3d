"""The JAX package's parameters, given as numpy arrays, as the port's
tensors.

The port keeps the JAX layouts (linears ``(d_in, d_out)``, layer-stacked
``(L, ...)`` leaves, QuanTA tensors ``(out_m, out_n, in_m, in_n)``), so
conversion is a plain copy.  Nothing here imports ``jax`` or ``repro``:
callers hand over nested dicts of arrays (anything ``numpy.asarray``
takes) and, for adapters, objects or dicts that carry the JAX adapter's
fields by name (``tensors``, ``dims_in``, ``dims_out``, ``pairs``;
``tree`` and ``specs`` for an adapter set).  A quantized weight (an object
with ``packed`` and ``scales``, as the JAX ``QuantizedLinear``) crosses as
a plain copy of its codes, scales and norms.  Fold-free adapters (a
``frozen`` copy S) are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.peft import AdapterLeafSpec, AdapterSet
from repro_torch.core.quanta import QuantaAdapter
from repro_torch.core.quantize import QuantizedLinear

__all__ = ["tensor_from_numpy", "params_from_numpy", "quanta_from_numpy",
           "adapter_set_from_numpy", "quantized_linear_from_numpy"]


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
    """A folded QuanTA adapter (flat or layer-stacked)."""
    if _field(adapter, "frozen") is not None:
        raise NotImplementedError("fold-free QuanTA is not ported yet")
    return QuantaAdapter(
        tuple(tensor_from_numpy(t, device)
              for t in _field(adapter, "tensors")),
        tuple(int(d) for d in _field(adapter, "dims_in")),
        tuple(int(d) for d in _field(adapter, "dims_out")),
        tuple((int(m), int(n)) for m, n in _field(adapter, "pairs")),
    )


def _adapter_tree(tree, device):
    return {
        k: _adapter_tree(v, device) if isinstance(v, dict)
        and "tensors" not in v else quanta_from_numpy(v, device)
        for k, v in tree.items()
    }


def adapter_set_from_numpy(adapter_set, device) -> AdapterSet:
    """An adapter set: its ``tree`` of QuanTA adapters and its ``specs``."""
    specs = tuple(
        AdapterLeafSpec(
            str(_field(s, "path")), str(_field(s, "method")),
            bool(_field(s, "stacked")), int(_field(s, "d_in")),
            int(_field(s, "d_out")),
        )
        for s in (_field(adapter_set, "specs") or ())
    )
    tree = _field(adapter_set, "tree")
    return AdapterSet(tree=_adapter_tree(tree, device), specs=specs)
