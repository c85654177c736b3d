"""Backend helpers shared by every kernel wrapper of the port.

A wrapper runs its plain PyTorch version when its tensors lie on the CPU
and launches its hand-written CUDA kernel when they lie on the card; any
other device raises.  There is no fallback from a CUDA tensor to the
plain version.

The CUDA kernels compute forward values only: a kernel writes into a
fresh tensor that autograd knows nothing of.  So :func:`route` refuses
the kernel route when autograd would need a gradient through it (grad
mode on and an operand that requires grad), instead of handing back an
output with no ``grad_fn`` (which would drop the gradient silently).  The
flash forward (kernel 3) is the one kernel with a backward: its wrapper
launches it inside a ``torch.autograd.Function``, where grad mode is off.
The plain versions are PyTorch and differentiate as they are.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MASK_VALUE", "masked_softmax", "route", "device_route",
           "default_device", "upload", "aligned16"]

# The additive mask for attention logits.  Finite (not -inf) so masked
# rows exp() to exactly 0.0 without NaN-producing inf-inf in the online
# softmax rescale; shared by the plain paths and the flash kernels.
MASK_VALUE = -1e30


def masked_softmax(scores: torch.Tensor, value_dtype,
                   fast: bool) -> torch.Tensor:
    """Row softmax of already-masked fp32 ``scores``, cast for the PV
    matmul.  ``fast=True`` keeps fp32 row statistics but the exp tensor in
    the value dtype."""
    if fast:
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - m).to(value_dtype)
        denom = e.float().sum(dim=-1, keepdim=True)
        return e / denom.to(value_dtype)
    return torch.softmax(scores, dim=-1).to(value_dtype)


def route(*tensors: torch.Tensor) -> str:
    """``"plain"`` when every tensor lies on the CPU, ``"cuda"`` when every
    tensor lies on one CUDA device; raises otherwise, and raises for the
    CUDA route when autograd would need a gradient through the kernel."""
    way = device_route(*tensors)
    if (way == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        raise RuntimeError(
            "this CUDA kernel has no backward: an operand requires grad "
            "with grad mode on, and the kernel's output would carry no "
            "gradient; run it under torch.no_grad() (serving), or train "
            "through the reference backend (cfg.peft_backend='reference')")
    return way


def device_route(*tensors: torch.Tensor) -> str:
    """The route by device alone (see :func:`route`)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return "plain"
    if dev.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for device {dev}")


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the card.

    Entry points never fall back to the CPU on their own: the CPU is used
    only when the caller passes ``device="cpu"``.
    """
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def seeded_generator(seed, device) -> torch.Generator:
    """``seed`` as the generator of an entry point's draws on ``device``:
    a ``torch.Generator`` is returned as it is, an int seeds a new one on
    ``device``.  The ``meta`` device draws nothing (its tensors hold no
    memory), so a CPU generator stands in for it there."""
    if isinstance(seed, torch.Generator):
        return seed
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(int(seed))
    return gen


def upload(dst: torch.Tensor, src) -> torch.Tensor:
    """Copy ``src`` (a numpy array or a tensor) into ``dst`` in place.  A
    host array bound for the card goes through pinned memory with
    ``non_blocking=True``: the copy is queued on the current stream and
    PyTorch's pinned-memory cache keeps the staging block until it has
    run, so ``dst`` keeps its storage and the host never waits."""
    if isinstance(src, np.ndarray):
        src = torch.from_numpy(np.ascontiguousarray(src))
        if dst.is_cuda:
            src = src.pin_memory()
    return dst.copy_(src.reshape(dst.shape), non_blocking=True)


def aligned16(t):
    """``t`` contiguous and 16-byte aligned, for kernels that copy 16-byte
    vectors (and TMA boxes); copied only when it is not.  ``None`` passes
    through."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
