"""The adapted linear ``y = x @ W + chain(x)``: two-phase CUDA kernel
(``csrc/quanta_apply.cu`` then ``csrc/quanta_linear.cu``) and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/quanta_linear.py``
(``quanta_linear_kernel_call``).  Hopper blocks run in no fixed order, so
the TPU kernel's per-row-block fp32 chain scratch cannot be carried across
column tiles.  Instead: (a) the chain kernel writes the chain of every row
once to a ``(rows, d_out)`` buffer in x's dtype; (b) a hand-written GEMM
computes ``x @ W`` with fp32 accumulators and adds the delta before one
rounding.  In bf16, (b) runs on ``wgmma``: a TMA-fed 128 x 256 tile body
for more than 64 rows, and for a decode tick a body that streams W over
every SM (K split, then an ordered sum of the splits plus the delta;
``kernels/smem.py`` ``quanta_linear_plan``).  There is no full-width
scratch, so the JAX wrapper's VMEM gate (``fused_vmem_ok``) has no
counterpart: every shape takes the kernel.

On a column-parallel shard (tensor parallelism over `model`) ``w`` holds
the rank's ``d_out`` columns of W at offset ``col`` and the chain runs
whole: (b) reads the delta's columns ``[col, col + d_out)`` in place, by
its row stride and that offset, so no copy of them is made.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.core.quanta import apply_sequential
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import aligned16, route
from repro_torch.kernels.quanta_apply import (
    _check, _launch_chain, chain_widths,
)
from repro_torch.kernels.smem import (
    LINEAR_DECODE, device_limits, quanta_linear_plan,
)

__all__ = ["quanta_linear", "quanta_linear_plain"]


def quanta_linear_plain(
    x: torch.Tensor,                      # (rows, d_in)
    w: torch.Tensor,                      # (d_in, d_out)
    tensors: Sequence[torch.Tensor],
    dims_in: Tuple[int, ...],
    pairs: Sequence[Tuple[int, int]],
    col: int = 0,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the chain in x's dtype,
    then ``x @ w`` accumulated in fp32 plus the chain's columns ``[col,
    col + d_out)``, rounded once."""
    delta = apply_sequential(x, tensors, dims_in, pairs)
    delta = delta[:, col:col + w.shape[1]]
    return (x.float() @ w.float() + delta.float()).to(x.dtype)


def _bind():
    fn = _build.load("quanta_linear").quanta_linear_gemm_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return fn


def quanta_linear(
    x: torch.Tensor,                      # (rows, d_in)
    w: torch.Tensor,                      # (d_in, d_out)
    tensors: Sequence[torch.Tensor],
    dims_in: Tuple[int, ...],
    pairs: Sequence[Tuple[int, int]],
    col: int = 0,
) -> torch.Tensor:
    """``x @ w + chain(x)[:, col:col + d_out]`` in x's dtype (``col`` > 0
    or ``d_out`` below the chain's width: ``w`` is a column shard).  CPU
    tensors run the plain version; CUDA tensors launch the two kernels or
    raise."""
    tensors = list(tensors)
    _check(x, tensors, dims_in, pairs)
    if w.dim() != 2 or w.shape[0] != x.shape[1] or w.dtype != x.dtype:
        raise ValueError(
            f"w {tuple(w.shape)} {w.dtype} does not fit x "
            f"{tuple(x.shape)} {x.dtype}"
        )
    width, _ = chain_widths(dims_in, [t.shape for t in tensors], pairs)
    if col < 0 or col + w.shape[1] > width:
        raise ValueError(f"columns [{col}, {col + w.shape[1]}) of a chain "
                         f"of width {width}")
    if route(x, w, *tensors) == "plain":
        return quanta_linear_plain(x, w, tensors, tuple(dims_in), pairs,
                                   col)
    rows, d_in = x.shape
    d_out = w.shape[1]
    if x.dtype == torch.bfloat16 and (d_in % 8 or d_out % 8):
        raise ValueError("the bf16 GEMM needs d_in and d_out multiples of 8")
    code = _build.dtype_code(x.dtype)
    limits = device_limits(x.device)
    plan = quanta_linear_plan(rows, d_in, d_out, code == 1, limits.sms)
    x = aligned16(x)
    w = aligned16(w)
    if x.dtype == torch.bfloat16 and (width % 2 or col % 2):
        raise ValueError("the bf16 GEMM reads the delta in pairs: the "
                         "chain's width and the column offset must be even")
    delta = _launch_chain(x, tensors, tuple(dims_in), pairs)   # phase (a)
    out = torch.empty((rows, d_out), dtype=x.dtype, device=x.device)
    # the decode body's fp32 partial products, one (rows, d_out) per split
    part = (torch.empty((plan.gsplits, rows, d_out), dtype=torch.float32,
                        device=x.device)
            if plan.variant == LINEAR_DECODE else None)
    rc = _bind()(
        code, plan.variant, ctypes.c_void_p(x.data_ptr()),
        ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(delta.data_ptr()),
        ctypes.c_void_p(0 if part is None else part.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), rows, d_out, d_in, width, col,
        plan.gsplits, limits.smem_block, _build.stream_ptr(),
    )                                                          # phase (b)
    _build.check(rc, "quanta_linear")
    quanta_linear.launches += 1
    return out


quanta_linear.launches = 0
