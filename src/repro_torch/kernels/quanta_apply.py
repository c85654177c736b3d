"""The fused QuanTA chain: CUDA kernel ``csrc/quanta_apply.cu`` and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/quanta_apply.py``
(``quanta_apply_kernel_call``).  ``quanta_apply`` takes the flattened
``x (rows, d_in)`` and the stage tensors in x's dtype; CPU tensors run
the plain version, ``core/quanta.py``'s :func:`apply_sequential`, which
rounds each stage to x's dtype as the kernel does; CUDA tensors launch
the kernel.  The kernel keeps a row tile in shared memory for the whole
chain (sized by ``kernels/smem.py``), so rows need no padding to a block
multiple.  bf16 takes the register-tiled body, whose stage layouts
``kernels/smem.py`` ``chain_plan`` lays out on the host; float32 keeps the
first SIMT body.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.quanta import apply_sequential
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import route
from repro_torch.kernels.smem import (
    chain_f32_plan, chain_plan, chain_plan_ints, device_limits,
)

__all__ = ["quanta_apply", "chain_widths"]


def chain_widths(dims_in: Sequence[int], shapes: Sequence[Sequence[int]],
                 pairs: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """``(d_out, d_max)``: the chain's output width and its widest
    register, from the stage tensor shapes ``(om, on, im, in)``."""
    cur = list(dims_in)
    d_max = math.prod(cur)
    for (om, on, _, _), (m, n) in zip(shapes, pairs):
        cur[m], cur[n] = om, on
        d_max = max(d_max, math.prod(cur))
    return math.prod(cur), d_max


def _check(x: torch.Tensor, tensors: Sequence[torch.Tensor],
           dims_in: Sequence[int], pairs) -> None:
    if x.dim() != 2 or x.shape[1] != math.prod(dims_in):
        raise ValueError(f"x {tuple(x.shape)} is not (rows, prod{dims_in})")
    if len(tensors) != len(pairs) or not tensors:
        raise ValueError("one stage tensor per axis pair, at least one")
    for t in tensors:
        if t.dtype != x.dtype or t.dim() != 4:
            raise ValueError("stage tensors must be 4-D in x's dtype")


def _row_cap(rows: int, sms: int) -> int:
    """Row-tile cap that gives about one block per SM or more (``sms`` of
    them): 8 rows at prefill, one row per block for an 8-slot decode
    tick."""
    cap = 1
    while cap < 8 and cap * 2 * sms <= rows:
        cap *= 2
    return cap


def _launch_chain(x: torch.Tensor, tensors: List[torch.Tensor],
                  dims_in: Tuple[int, ...],
                  pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Launch the chain on the current stream (bf16: the register-tiled
    body on its host plan; float32: the first SIMT body); counts one
    launch of the chain kernel (also when ``quanta_linear`` calls it)."""
    code = _build.dtype_code(x.dtype)
    x = x.contiguous()
    tensors = [t.contiguous() for t in tensors]
    shapes = tuple(tuple(t.shape) for t in tensors)
    d_out, _ = chain_widths(dims_in, shapes, pairs)
    limits = device_limits(x.device)
    cap = _row_cap(x.shape[0], limits.sms)
    out = torch.empty((x.shape[0], d_out), dtype=x.dtype, device=x.device)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    x_p, out_p = ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr())
    rows = ctypes.c_longlong(x.shape[0])
    if code == 1:
        plan = chain_plan(dims_in, shapes, tuple(map(tuple, pairs)),
                          limits.smem_block, cap)
        ints = chain_plan_ints(plan)
        rc = _bind_bf16()(
            x_p, out_p, rows, (ctypes.c_int * len(ints))(*ints), len(ints),
            ptrs, plan.smem, limits.smem_block, _build.stream_ptr())
    else:
        rows_per_block, t_floats = chain_f32_plan(
            dims_in, shapes, pairs, limits.smem_block, cap=cap)
        meta = [len(dims_in), len(pairs), *dims_in]
        for s, (m, n) in zip(shapes, pairs):
            meta += [m, n, *s]
        meta.append(t_floats)
        rc = _bind()(
            code, x_p, out_p, rows, (ctypes.c_int * len(meta))(*meta), ptrs,
            rows_per_block, limits.smem_block, _build.stream_ptr())
    _build.check(rc, "quanta_apply")
    quanta_apply.launches += 1
    return out


def _bind():
    fn = _build.load("quanta_apply").quanta_apply_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
    return fn


def _bind_bf16():
    fn = _build.load("quanta_apply").quanta_chain_bf16_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
    return fn


def quanta_apply(
    x: torch.Tensor,                      # (rows, d_in)
    tensors: Sequence[torch.Tensor],
    dims_in: Tuple[int, ...],
    pairs: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """The QuanTA chain of every row of ``x``; ``(rows, d_out)`` in x's
    dtype.  CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    tensors = list(tensors)
    _check(x, tensors, dims_in, pairs)
    if route(x, *tensors) == "plain":
        return apply_sequential(x, tensors, tuple(dims_in), pairs)
    return _launch_chain(x, tensors, tuple(dims_in), pairs)


quanta_apply.launches = 0
