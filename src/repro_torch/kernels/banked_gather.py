"""Banked-gather LoRA: per batch slot, the adapter row named by that slot's
id, applied with or without the shared base product -- the CUDA kernel in
``csrc/banked_gather.cu`` and its plain versions in ``kernels/ref.py``.

Replaces the TPU kernel ``repro/kernels/banked_gather.py`` (``_call``,
wrappers ``banked_lora_delta`` and ``banked_lora_linear``)::

    y[s] = x[s] @ W + scale * ((x[s] @ A[ids[s]]) @ B[ids[s]])

over a bank ``A (G+1, d_in, r)``, ``B (G+1, r, d_out)`` whose row 0 is
neutral (all zeros), so slots with id 0 get exactly ``x[s] @ W``.  The TPU
kernel keeps the whole ``d_in`` of a slot in VMEM and its JAX caller
(``LoraAdapter._banked_kernel_ok``) sends shapes that overflow it, which
are the prefill shapes at llama2-7b widths, to the reference gather.  The
CUDA kernel tiles K (``kernels/smem.py``, ``banked_gather_plan``), so it
runs at every shape, prefill and decode alike: a CUDA tensor takes the
kernel or the wrapper raises.  In bf16 the base product runs on ``wgmma``:
a TMA-fed 128 x 128 tile body for more than 64 rows, a body that streams
W over every SM (K split, an ordered combine) for a decode tick.  ``ids`` stays a device int32 tensor; the
wrappers never read it on the host.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import aligned16, route
from repro_torch.kernels.ref import (
    banked_lora_delta_ref, banked_lora_linear_ref,
)
from repro_torch.kernels.smem import (
    BANKED_DECODE, banked_gather_plan, device_limits,
)

__all__ = ["banked_lora_delta", "banked_lora_linear"]

_NULL = ctypes.c_void_p(0)


def _bind():
    fn = _build.load("banked_gather").banked_lora_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _ptr(t) -> ctypes.c_void_p:
    return _NULL if t is None else ctypes.c_void_p(t.data_ptr())


def _norm_x(x: torch.Tensor):
    """(B, d) -> (B, 1, d); (B, S, d) passes through."""
    if x.dim() == 2:
        return x[:, None, :], True
    if x.dim() == 3:
        return x, False
    raise ValueError(
        f"banked gather expects (B, d) or (B, S, d), got {tuple(x.shape)}")


def _check(x, a, b, ids, w):
    n_slots, _, d_in = x.shape
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]
            or a.shape[1] != d_in or a.shape[2] != b.shape[1]):
        raise ValueError(
            f"bank A {tuple(a.shape)} / B {tuple(b.shape)} does not fit x "
            f"{tuple(x.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"A is {a.dtype} but B is {b.dtype}")
    if ids.shape != (n_slots,):
        raise ValueError(f"ids {tuple(ids.shape)} != ({n_slots},)")
    if w is not None and (tuple(w.shape) != (d_in, b.shape[2])
                          or w.dtype != x.dtype):
        raise ValueError(f"w {tuple(w.shape)} {w.dtype} incompatible with "
                         f"x/b")


def _launch(x, a, b, ids, w, scale: float) -> torch.Tensor:
    """Shrink then expand on the card; ``w`` None drops the base."""
    n_slots, seq, d_in = x.shape
    n_bank, rank, d_out = b.shape
    x_code, a_code = _build.dtype_code(x.dtype), _build.dtype_code(a.dtype)
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if w is not None and x_code == 1 and (d_in % 8 or d_out % 8):
        raise ValueError("the bf16 base product needs d_in and d_out "
                         "multiples of 8")
    limits = device_limits(x.device)
    plan = banked_gather_plan(n_slots, seq, d_in, d_out, rank,
                              x_code == 1, limits.sms)
    x = aligned16(x)
    a, b, ids = a.contiguous(), b.contiguous(), ids.contiguous()
    w = None if w is None else aligned16(w)
    za = torch.empty((n_slots * seq, rank), dtype=torch.float32,
                     device=x.device)
    zpart = (torch.empty((plan.splits, n_slots * seq, rank),
                         dtype=torch.float32, device=x.device)
             if plan.splits > 1 else None)
    gpart = (torch.empty((plan.gsplits, n_slots * seq, d_out),
                         dtype=torch.float32, device=x.device)
             if w is not None and plan.variant == BANKED_DECODE else None)
    out = torch.empty((n_slots, seq, d_out), dtype=x.dtype, device=x.device)
    rc = _bind()(
        x_code, a_code, plan.variant, _ptr(x), _ptr(a), _ptr(b), _ptr(ids),
        _ptr(w), _ptr(za), _ptr(zpart), _ptr(gpart), _ptr(out), n_slots, seq,
        d_in, d_out, rank, n_bank, float(scale), plan.splits, plan.k_split,
        plan.gsplits, limits.smem_block, _build.stream_ptr(),
    )
    _build.check(rc, "banked_gather")
    return out


def banked_lora_delta(
    x: torch.Tensor,              # (B, S, d_in) or (B, d_in)
    a: torch.Tensor,              # (G+1, d_in, r) bank-stacked A
    b: torch.Tensor,              # (G+1, r, d_out) bank-stacked B
    ids: torch.Tensor,            # (B,) int32 local bank rows, 0 = neutral
    *,
    scale: float,
) -> torch.Tensor:
    """Gathered per-slot LoRA delta (no base) in x's dtype.  CPU tensors
    run :func:`banked_lora_delta_ref`; CUDA tensors launch the kernel or
    raise."""
    xn, squeezed = _norm_x(x)
    _check(xn, a, b, ids, None)
    if route(xn, a, b, ids) == "plain":
        out = banked_lora_delta_ref(xn, a, b, ids, scale)
    else:
        out = _launch(xn, a, b, ids, None, scale)
        banked_lora_delta.launches += 1
    return out[:, 0, :] if squeezed else out


def banked_lora_linear(
    x: torch.Tensor,              # (B, S, d_in) or (B, d_in)
    w: torch.Tensor,              # (d_in, d_out) shared dense base
    a: torch.Tensor,
    b: torch.Tensor,
    ids: torch.Tensor,
    *,
    scale: float,
) -> torch.Tensor:
    """Fused ``x @ W`` plus the gathered LoRA delta, in x's dtype.  CPU
    tensors run :func:`banked_lora_linear_ref`; CUDA tensors launch the
    kernel or raise."""
    xn, squeezed = _norm_x(x)
    _check(xn, a, b, ids, w)
    if route(xn, w, a, b, ids) == "plain":
        out = banked_lora_linear_ref(xn, w, a, b, ids, scale)
    else:
        out = _launch(xn, a, b, ids, w, scale)
        banked_lora_linear.launches += 1
    return out[:, 0, :] if squeezed else out


banked_lora_delta.launches = 0
banked_lora_linear.launches = 0
