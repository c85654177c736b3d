"""Shared model-building blocks, dense subset (port of
``repro/models/common.py``): config, cache slot layout and surgery, norms,
RoPE, init helpers.

Parameters are nested dicts of tensors with the JAX package's layouts
(linears ``(d_in, d_out)``, stacked ``(L, d_in, d_out)`` over layers), so
weights carry over from the JAX package by a plain copy.  The dense cache
is ``{"k", "v": (L, B, S_max, KV, hd), "len": (B,) int32}``; unlike the
JAX package's immutable arrays, the port updates its leaves in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = [
    "ModelConfig",
    "CacheLeafSpec",
    "merge_cache_slots",
    "insert_cache_slots",
    "rms_norm",
    "make_rope",
    "apply_rope",
    "dense_init",
    "embed_init",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of the dense family, with the JAX
    package's field names and torch dtypes.  ``kv_cache``, ``base_quant``
    and ``kv_quant`` name paths the port does not run yet; the model
    refuses them."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # "reference" = plain PyTorch attention; "pallas" = the hand-written
    # CUDA flash kernels (the name is kept so that configs carry over)
    attn_backend: str = "reference"
    # "reference" = adapter protocol in plain PyTorch; "pallas" = QuanTA
    # linears through the hand-written quanta_linear kernel
    peft_backend: str = "reference"
    q_block: int = 512            # query tile of the reference attention
    fast_softmax: bool = False    # reference attention only
    kv_cache: str = "dense"
    base_quant: Optional[str] = None
    kv_quant: Optional[str] = None
    quanta_scheme: Optional[str] = None

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Decode-cache slot layout and surgery (in place)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheLeafSpec:
    """Slot layout of one decode-cache leaf: the axis indexed by serving
    slot."""

    slot_axis: int


def _slot_index(leaf: torch.Tensor, axis: int, ids) -> list:
    idx = [slice(None)] * leaf.dim()
    idx[axis] = torch.as_tensor(ids, dtype=torch.long, device=leaf.device)
    return idx


def merge_cache_slots(spec: Dict[str, CacheLeafSpec], new_cache, old_cache,
                      active):
    """Keep ``new_cache`` stripes only where ``active`` (bool per slot).

    A leaf that the decode step updated in place (``new is old``) is kept
    as it is: the stripes of inactive slots then hold entries past their
    length, which every reader masks and the next admission overwrites.
    """
    out = dict(old_cache)
    for key, ls in spec.items():
        new, old = new_cache[key], old_cache[key]
        if new is old:
            continue
        act = torch.as_tensor(active, dtype=torch.bool, device=new.device)
        sel = act.reshape(
            (1,) * ls.slot_axis + (-1,) + (1,) * (new.dim() - ls.slot_axis - 1)
        )
        out[key] = torch.where(sel, new, old)
    return out


def insert_cache_slots(spec: Dict[str, CacheLeafSpec], cache, slot_ids,
                       prefill_cache, lengths=None):
    """Scatter the first ``len(slot_ids)`` stripes of a prefill wave into
    ``cache`` at ``slot_ids``, in place.  Wave axes shorter than the cache
    are written as a prefix (every reader masks by the slot's length);
    ``lengths`` overrides the wave's ``len`` leaf."""
    if lengths is not None:
        prefill_cache = dict(prefill_cache, len=torch.as_tensor(
            lengths, dtype=torch.int32, device=cache["len"].device))
    n = len(slot_ids)
    for key, ls in spec.items():
        dst, src = cache[key], prefill_cache[key]
        ax = ls.slot_axis
        src = src.narrow(ax, 0, n)
        idx = _slot_index(dst, ax, slot_ids)
        for d in range(dst.dim()):
            if d == ax or src.shape[d] == dst.shape[d]:
                continue
            if src.shape[d] > dst.shape[d]:
                src = src.narrow(d, 0, dst.shape[d])
            else:
                idx[d] = slice(0, src.shape[d])
        dst[tuple(idx)] = src.to(dst.dtype)
    return cache


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with fp32 accumulation."""
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * scale.float()).to(x.dtype)


def make_rope(positions: torch.Tensor, head_dim: int, theta: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for integer ``positions (...,)`` -> ``cos/sin (...,
    head_dim//2)`` in fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotary embedding of ``x (B, S, H, hd)`` with tables ``(B, S,
    hd//2)``; pairs are (x[..., :half], x[..., half:])."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x1.dtype)
    s = sin[..., None, :].to(x1.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std: float, generator: torch.Generator, device
                  ) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0,
                                       generator=generator) * std


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LLaMA-style), drawn in fp32."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _trunc_normal((d_in, d_out), std, generator, device).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return _trunc_normal((vocab, d), 0.02, generator, device).to(dtype)
