"""The fused dequant-matmul ``y = x @ dequant(Wq)`` for blockwise NF4 /
int8 frozen weights: the CUDA kernel in ``csrc/quantized_matmul.cu`` and
its plain version, ``core/quantize.matmul_ref``.

Replaces the TPU kernel ``repro/kernels/quantized_matmul.py``
(``quantized_matmul_kernel_call``, wrapper ``quantized_matmul``).  The
TPU kernel keeps the whole ``d_in`` per tile and its wrapper falls back to
the reference when that tile overflows VMEM, which it does at llama2-7b
widths.  The CUDA kernel tiles K instead (64 rows per step), so there is
no gate and no fallback: a CUDA tensor takes the kernel or the wrapper
raises.  bf16 runs one of two wgmma bodies, prefill (more than 64 rows)
or decode (at most 64), float32 a SIMT tile; the body and the K split
come from ``kernels/smem.py`` (``quantized_matmul_plan``, cached per
shape).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import QuantizedLinear, codebook, matmul_ref
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import aligned16, route
from repro_torch.kernels.smem import (
    device_limits, qmm_check_block, quantized_matmul_plan,
)

__all__ = ["quantized_matmul", "quantized_matmul_plain"]

quantized_matmul_plain = matmul_ref

_FMT_CODES = {"nf4": 0, "int8": 1}
_NULL = ctypes.c_void_p(0)


def _bind():
    fn = _build.load("quantized_matmul").quantized_matmul_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return fn


def _ptr(t) -> ctypes.c_void_p:
    return _NULL if t is None else ctypes.c_void_p(t.data_ptr())


def quantized_matmul(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """``x @ dequant(qw)`` in x's dtype for a 2-D quantized weight; x may
    have leading batch axes.  CPU tensors run :func:`matmul_ref`; CUDA
    tensors launch the kernel or raise."""
    if qw.ndim != 2:
        raise ValueError(f"quantized_matmul needs a 2-D weight, got "
                         f"{qw.shape}")
    d_in, d_out = qw.shape
    if x.shape[-1] != d_in:
        raise ValueError(f"x {tuple(x.shape)} does not fit the weight "
                         f"{qw.shape}")
    if route(x, *qw.tensors()) == "plain":
        return matmul_ref(x, qw)
    code = _build.dtype_code(x.dtype)
    if d_in % 8:
        raise ValueError(f"the kernel needs d_in % 8 == 0, got {d_in}")
    if qw.fmt not in _FMT_CODES:
        raise ValueError(f"unknown quantization format {qw.fmt!r}")
    if any(t.dtype != torch.float32 for t in qw.tensors()[1:]):
        raise ValueError("the kernel takes fp32 scales and norms")
    batch = x.shape[:-1]
    xf = aligned16(x.reshape(-1, d_in))
    rows = xf.shape[0]
    dev = x.device
    bs = d_in if qw.block_size is None else int(qw.block_size)
    qmm_check_block(bs, code == 1)
    limits = device_limits(dev)
    # the entry point refuses a block that needs more shared memory than
    # ``limits.smem_block`` (``qmm_smem_bytes``), and the wrapper raises
    plan = quantized_matmul_plan(rows, d_in, d_out, code == 1, limits.sms)
    out = torch.empty((rows, d_out), dtype=x.dtype, device=dev)
    partial = (torch.empty((plan.splits, rows, d_out), dtype=torch.float32,
                           device=dev) if plan.splits > 1 else None)
    packed, scales = aligned16(qw.packed), aligned16(qw.scales)
    row, col = aligned16(qw.row_norm), aligned16(qw.col_norm)
    rc = _bind()(
        code, _FMT_CODES[qw.fmt], plan.variant, _ptr(xf), _ptr(packed),
        _ptr(scales), _ptr(row), _ptr(col),
        _ptr(codebook(dev) if qw.fmt == "nf4" else None), _ptr(out),
        _ptr(partial), rows, d_out, d_in, bs, plan.splits,
        limits.smem_block, _build.stream_ptr(),
    )
    _build.check(rc, "quantized_matmul")
    quantized_matmul.launches += 1
    return out.reshape(*batch, d_out)


quantized_matmul.launches = 0
