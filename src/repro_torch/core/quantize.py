"""Blockwise frozen-base weight and KV-row quantization, NF4 / int8 (port
of ``repro/core/quantize.py``).

* :class:`QuantizedLinear` -- one frozen linear weight as packed codes
  (NF4: two 4-bit codebook indices per ``uint8`` along ``d_in``, high
  nibble = even row; int8: one code per row) with per-block fp32 absmax
  scales along ``d_in`` and optional row/column normalizers.  Its tensors
  may carry a leading layer axis; ``layer(l)`` is the view of one layer.
* :func:`quantize_linear` / :func:`dequantize` -- the lossy encode and the
  exact decode; :func:`dequant_values` is the one elementwise decode the
  plain matmul (:func:`matmul_ref`) uses, and the CUDA kernel
  (``kernels/quantized_matmul.py``) repeats it element for element.
* :func:`quantize_kv` / :func:`kv_dequant_values` / :func:`fake_quantize_kv`
  -- KV rows quantized along head_dim (high nibble = even element), for
  the paged pools and the dense reference cache.
* :func:`base_matmul` -- the frozen-base linear under every adapter:
  ``x @ w`` for a dense weight, the dequant-matmul for a quantized one.
* :func:`quantize_params` -- quantize every projection in
  :data:`QUANT_TARGETS` of a parameter tree.

Codes and scales equal the JAX package's bit for bit: the same
``searchsorted`` (``right=True`` is JAX's ``side="right"``), the same
round-half-to-even, the same division by the expanded scales and the same
``eps`` clamp.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "NF4_CODEBOOK",
    "QUANT_TARGETS",
    "QuantizedLinear",
    "base_matmul",
    "blockwise_absmax",
    "blockwise_round",
    "blockwise_scales",
    "codebook",
    "dequant_values",
    "dequantize",
    "ensure_dense",
    "expand_scales",
    "fake_quantize_kv",
    "kv_dequant_values",
    "matmul_ref",
    "quantize_kv",
    "quantize_linear",
    "quantize_params",
    "quantized_nbytes",
]

# The 16-level NF4 codebook (QLoRA): quantiles of a standard normal
# rescaled to span [-1, 1], with 0.0 exact (code 7).
NF4_CODEBOOK = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367,
        -0.39491748809814453, -0.28444138169288635, -0.18477343022823334,
        -0.09105003625154495, 0.0, 0.07958029955625534,
        0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
        0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
    ],
    np.float32,
)
# nearest-code decision boundaries: midpoints of adjacent entries
_NF4_BOUNDS = (NF4_CODEBOOK[:-1] + NF4_CODEBOOK[1:]) / 2.0

# projections applied through peft_linear (the JAX package's list; the
# port's dense family has the first seven)
QUANT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
    "rec_proj", "z_proj", "x_proj", "out_proj",
)

_FORMATS = ("nf4", "int8")


@functools.lru_cache(maxsize=None)
def codebook(device) -> torch.Tensor:
    """The NF4 codebook as fp32 on ``device`` (one tensor per device,
    never written)."""
    return torch.from_numpy(NF4_CODEBOOK).to(device)


@functools.lru_cache(maxsize=None)
def _bounds(device) -> torch.Tensor:
    """The NF4 decision bounds on ``device``, one tensor per device, so a
    decode tick captured in a CUDA graph copies nothing from the host."""
    return torch.from_numpy(_NF4_BOUNDS).to(device)


# ---------------------------------------------------------------------------
# Blockwise scale / round helpers
# ---------------------------------------------------------------------------

def blockwise_absmax(x: torch.Tensor, block_size: Optional[int],
                     axis: int = 0) -> torch.Tensor:
    """Per-block absmax along ``axis``; ``block_size=None`` makes the
    whole axis one block.  A remainder block is zero-padded."""
    axis = axis % x.dim()
    n = x.shape[axis]
    bs = n if block_size is None else block_size
    nb = -(-n // bs)
    pad = nb * bs - n
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    shp = x.shape
    x = x.reshape(shp[:axis] + (nb, bs) + shp[axis + 1:])
    return x.abs().amax(dim=axis + 1)


def blockwise_scales(x: torch.Tensor, block_size: Optional[int],
                     axis: int = 0, levels: float = 127.0,
                     eps: float = 1e-12) -> torch.Tensor:
    """Per-block positive scales ``max(absmax, eps) / levels``.  The
    divisor is a full tensor: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, which can differ in the last bit."""
    a = blockwise_absmax(x, block_size, axis).clamp_min(eps)
    return a / torch.full_like(a, levels)


def expand_scales(scales: torch.Tensor, block_size: Optional[int], n: int,
                  axis: int = 0) -> torch.Tensor:
    """Per-block scales repeated back to ``n`` elements along ``axis``
    (a remainder block overshoots, then is cut).  ``block_size=None``:
    the whole axis is one block."""
    axis = axis % scales.dim()
    reps = n if block_size is None else block_size
    return scales.repeat_interleave(reps, dim=axis).narrow(axis, 0, n)


def blockwise_round(x: torch.Tensor, scales: torch.Tensor,
                    block_size: Optional[int], axis: int = 0,
                    levels: int = 127) -> torch.Tensor:
    """``clip(round(x / scale), -levels, levels)``, round half to even."""
    axis = axis % x.dim()
    s = expand_scales(scales, block_size, x.shape[axis], axis)
    return torch.clamp(torch.round(x / s), -levels, levels)


def _nf4_codes(v: torch.Tensor) -> torch.Tensor:
    """Nearest NF4 code of each value (already divided by its scale)."""
    return torch.searchsorted(_bounds(v.device),
                              torch.clamp(v, -1.0, 1.0).contiguous(),
                              right=True).to(torch.uint8)


# ---------------------------------------------------------------------------
# The packed weight format
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantizedLinear:
    """One frozen linear weight in blockwise-quantized storage.

    * ``packed`` -- NF4: ``uint8 (..., d_in//2, d_out)``, high nibble = row
      ``2k``, low = row ``2k+1``; int8: ``int8 (..., d_in, d_out)``.
    * ``scales`` -- ``(..., ceil(d_in/block_size), d_out)`` absmax scales.
    * ``row_norm`` / ``col_norm`` -- optional ``(..., d_in)`` / ``(...,
      d_out)`` normalizers, multiplied back at dequantization.
    * ``fmt`` ("nf4" | "int8"), ``block_size`` and ``dtype`` (the original
      weight's torch dtype).
    """

    packed: torch.Tensor
    scales: torch.Tensor
    fmt: str
    block_size: int
    dtype: torch.dtype
    row_norm: Optional[torch.Tensor] = None
    col_norm: Optional[torch.Tensor] = None

    @property
    def d_in(self) -> int:
        return self.packed.shape[-2] * (2 if self.fmt == "nf4" else 1)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.packed.shape[:-2]) + (self.d_in,
                                                self.packed.shape[-1])

    @property
    def ndim(self) -> int:
        return self.packed.dim()

    def tensors(self):
        return [t for t in (self.packed, self.scales, self.row_norm,
                            self.col_norm) if t is not None]

    def _map(self, fn) -> "QuantizedLinear":
        return dataclasses.replace(
            self, packed=fn(self.packed), scales=fn(self.scales),
            row_norm=None if self.row_norm is None else fn(self.row_norm),
            col_norm=None if self.col_norm is None else fn(self.col_norm),
        )

    def layer(self, index: int) -> "QuantizedLinear":
        """The weight of one layer of a layer-stacked weight (views)."""
        return self._map(lambda t: t[index])


def quantized_nbytes(qw: QuantizedLinear) -> int:
    """Stored bytes of one quantized weight (packed + scales + norms)."""
    return sum(t.numel() * t.element_size() for t in qw.tensors())


# ---------------------------------------------------------------------------
# Encode (lossy) / decode (exact)
# ---------------------------------------------------------------------------

def _rms(w32: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sqrt(torch.mean(w32 * w32, dim=dim)).clamp_min(1e-12)


def quantize_linear(
    w: torch.Tensor,
    fmt: str = "nf4",
    *,
    block_size: int = 64,
    normalize: Optional[str] = None,
    scale_dtype: Any = torch.float32,
) -> QuantizedLinear:
    """Blockwise-quantize a ``(d_in, d_out)`` or layer-stacked ``(L, d_in,
    d_out)`` weight, blocks along ``d_in``.  ``normalize`` in {None,
    "row", "col", "rowcol"} divides out RMS normalizers first.  A stacked
    weight is quantized layer by layer (each layer's blocks and norms are
    its own), which keeps the fp32 temporaries to one layer."""
    if w.dim() not in (2, 3):
        raise ValueError(f"expected a 2-D or layer-stacked 3-D weight, "
                         f"got ndim={w.dim()}")
    if fmt not in _FORMATS:
        raise ValueError(f"unknown quantization format {fmt!r}")
    if normalize not in (None, "row", "col", "rowcol"):
        raise ValueError(f"unknown normalize mode {normalize!r}")
    if w.dim() == 3:
        layers = [quantize_linear(w[i], fmt, block_size=block_size,
                                  normalize=normalize,
                                  scale_dtype=scale_dtype)
                  for i in range(w.shape[0])]

        def stack(name):
            parts = [getattr(q, name) for q in layers]
            return None if parts[0] is None else torch.stack(parts)

        return dataclasses.replace(
            layers[0], packed=stack("packed"), scales=stack("scales"),
            row_norm=stack("row_norm"), col_norm=stack("col_norm"))
    d_in = w.shape[-2]
    w32 = w.float()
    row_norm = col_norm = None
    if normalize in ("row", "rowcol"):
        row_norm = _rms(w32, -1)
        w32 = w32 / row_norm[..., :, None]
    if normalize in ("col", "rowcol"):
        col_norm = _rms(w32, -2)
        w32 = w32 / col_norm[..., None, :]
    if fmt == "nf4":
        if d_in % 2:
            raise ValueError(
                f"NF4 packs two codes per byte along d_in; d_in={d_in} "
                "must be even")
        scales = blockwise_scales(w32, block_size, axis=-2, levels=1.0)
        codes = _nf4_codes(
            w32 / expand_scales(scales, block_size, d_in, axis=-2))
        packed = (codes[..., 0::2, :] << 4) | codes[..., 1::2, :]
    else:
        scales = blockwise_scales(w32, block_size, axis=-2, levels=127.0)
        packed = blockwise_round(w32, scales, block_size, axis=-2,
                                 levels=127).to(torch.int8)
    return QuantizedLinear(
        packed=packed.contiguous(), scales=scales.to(scale_dtype),
        fmt=fmt, block_size=block_size, dtype=w.dtype,
        row_norm=row_norm, col_norm=col_norm,
    )


def _unpack_nf4(packed: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Codes of a packed NF4 tensor along ``axis`` (length ``n``): element
    ``2k`` from the high nibble of byte ``k``, ``2k+1`` from the low."""
    hi = (packed >> 4).long()
    lo = (packed & 0xF).long()
    codes = torch.stack([hi, lo], dim=axis + 1)
    shp = packed.shape
    return codes.reshape(shp[:axis] + (n,) + shp[axis + 1:])


def dequant_values(
    packed: torch.Tensor,
    scales: torch.Tensor,
    row_norm: Optional[torch.Tensor],
    col_norm: Optional[torch.Tensor],
    *,
    fmt: str,
    block_size: Optional[int],
    d_in: int,
    codebook_values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Elementwise fp32 dequantization: ``code value * block scale``,
    times the row norm, times the column norm, in that order."""
    if fmt == "nf4":
        axis = packed.dim() - 2
        cb = (codebook(packed.device) if codebook_values is None
              else codebook_values)
        vals = cb[_unpack_nf4(packed, axis, d_in)]
    elif fmt == "int8":
        vals = packed.float()
    else:
        raise ValueError(f"unknown quantization format {fmt!r}")
    w = vals * expand_scales(scales.float(), block_size, d_in, axis=-2)
    if row_norm is not None:
        w = w * row_norm.float()[..., :, None]
    if col_norm is not None:
        w = w * col_norm.float()[..., None, :]
    return w


def dequantize(qw: QuantizedLinear, dtype=None) -> torch.Tensor:
    """The dense weight (fp32 internally, cast to the stored dtype by
    default)."""
    w = dequant_values(qw.packed, qw.scales, qw.row_norm, qw.col_norm,
                       fmt=qw.fmt, block_size=qw.block_size, d_in=qw.d_in)
    return w.to(qw.dtype if dtype is None else dtype)


def ensure_dense(w, dtype=None):
    """A dense view of a maybe-quantized weight."""
    if isinstance(w, QuantizedLinear):
        return dequantize(w, dtype)
    return w


# ---------------------------------------------------------------------------
# KV-row quantization (the paged pools)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor, fmt: str, *, block_size: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-quantize KV rows along the last axis (head_dim), one row
    at a time: ``(codes, scales)``, NF4 ``uint8 (..., d//2)`` (high nibble
    = even element) or int8 ``(..., d)``, scales fp32 ``(...,
    ceil(d/block_size))``."""
    if fmt not in _FORMATS:
        raise ValueError(f"unknown quantization format {fmt!r}")
    d = x.shape[-1]
    x32 = x.float()
    if fmt == "nf4":
        if d % 2:
            raise ValueError(
                f"NF4 packs two codes per byte along head_dim; d={d} "
                "must be even")
        scales = blockwise_scales(x32, block_size, axis=-1, levels=1.0)
        codes = _nf4_codes(x32 / expand_scales(scales, block_size, d,
                                               axis=-1))
        packed = (codes[..., 0::2] << 4) | codes[..., 1::2]
    else:
        scales = blockwise_scales(x32, block_size, axis=-1, levels=127.0)
        packed = blockwise_round(x32, scales, block_size, axis=-1,
                                 levels=127).to(torch.int8)
    return packed, scales.float()


def kv_dequant_values(codes: torch.Tensor, scales: torch.Tensor, *,
                      fmt: str, block_size: int, d: int,
                      codebook_values: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """fp32 KV rows from their codes: :func:`dequant_values` through a
    trailing singleton axis."""
    return dequant_values(
        codes[..., None], scales[..., None], None, None, fmt=fmt,
        block_size=block_size, d_in=d, codebook_values=codebook_values,
    )[..., 0]


def fake_quantize_kv(x: torch.Tensor, fmt: str, *, block_size: int = 64
                     ) -> torch.Tensor:
    """The quantize-dequantize round trip at x's dtype: what the dense
    reference cache holds, equal to what the paged pools decode to."""
    codes, scales = quantize_kv(x, fmt, block_size=block_size)
    return kv_dequant_values(codes, scales, fmt=fmt, block_size=block_size,
                             d=x.shape[-1]).to(x.dtype)


# ---------------------------------------------------------------------------
# The base matmul every adapter apply routes through
# ---------------------------------------------------------------------------

def matmul_ref(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """Dequantize-then-matmul: the fp32 dequantized weight cast to x's
    dtype, one product accumulated in fp32, rounded once to x's dtype.
    The plain version of the quantized matmul kernel."""
    if qw.ndim != 2:
        raise ValueError(f"matmul_ref needs a 2-D weight, got {qw.shape}")
    w = dequantize(qw, torch.float32).to(x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def base_matmul(x: torch.Tensor, w, backend: str = "reference"
                ) -> torch.Tensor:
    """``x @ w`` for a dense frozen base (the library matmul, as the JAX
    package left it to XLA); for a :class:`QuantizedLinear` the fused
    dequant-matmul kernel (``backend="pallas"``, the name the configs
    carry) or :func:`matmul_ref`."""
    if isinstance(w, QuantizedLinear):
        if backend == "pallas":
            from repro_torch.kernels.quantized_matmul import (
                quantized_matmul,
            )

            return quantized_matmul(x, w)
        return matmul_ref(x, w)
    return x @ w


# ---------------------------------------------------------------------------
# Whole-tree quantization
# ---------------------------------------------------------------------------

def quantize_params(
    params: Dict[str, Any],
    fmt: str,
    *,
    block_size: int = 64,
    targets: Tuple[str, ...] = QUANT_TARGETS,
    normalize: Optional[str] = None,
    scale_dtype: Any = torch.float32,
) -> Dict[str, Any]:
    """Quantize every targeted 2-D or 3-D projection of a parameter tree;
    every other leaf is passed through and already quantized leaves are
    kept (idempotent)."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif (key in targets and isinstance(val, torch.Tensor)
                  and val.dim() in (2, 3)):
                out[key] = quantize_linear(
                    val, fmt, block_size=block_size, normalize=normalize,
                    scale_dtype=scale_dtype)
            else:
                out[key] = val
        return out

    return walk(params)
