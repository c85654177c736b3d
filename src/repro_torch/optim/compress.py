"""Int8 gradient compression with error feedback (port of
``repro/optim/compress.py``).

:func:`ef_compress_grads` quantizes each gradient plus its carried
residual to int8 with one per-tensor scale, hands on the dequantized
gradient and keeps the new residual, which keeps the compression unbiased
over time (Karimireddy et al. 2019).  Scales and rounding are the shared
``core.quantize`` helpers of the blockwise weight quantizer (per-tensor is
the single-block case).  :func:`compressed_psum` is an all-reduce that
moves int8 codes: each rank quantizes its tensor, the codes and scales
are all-gathered over one axis of a ``DeviceMesh``, and every rank sums
the dequantized replicas.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.adapters import tree_map, tree_unflatten
from repro_torch.core.quantize import blockwise_round, blockwise_scales

__all__ = ["ErrorFeedbackState", "compress_int8", "decompress_int8",
           "ef_init", "ef_compress_grads", "compressed_psum"]


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackState:
    error: Any  # fp32 residuals, the structure of the gradients


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``(codes, scale)``."""
    flat = x.float().reshape(-1)
    scale = blockwise_scales(flat, None, axis=0, levels=127.0)
    q = blockwise_round(flat, scale, flat.shape[0], axis=0, levels=127)
    return q.to(torch.int8).reshape(x.shape), scale[0]


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(grads_template: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(error=tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), grads_template))


@torch.no_grad()
def ef_compress_grads(grads: Any, state: ErrorFeedbackState
                      ) -> Tuple[Any, ErrorFeedbackState]:
    """Quantize (grad + error); return the dequantized grads and the new
    residuals."""
    out = []

    def one(g, e):
        corrected = g.float() + e
        q, scale = compress_int8(corrected)
        deq = decompress_int8(q, scale)
        out.append((deq.to(g.dtype), corrected - deq))

    tree_map(one, grads, state.error)
    deq, err = (tree_unflatten(grads, leaves) for leaves in zip(*out))
    return deq, ErrorFeedbackState(error=err)


@torch.no_grad()
def compressed_psum(x: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``mesh``'s ``axis_name`` axis, with
    int8 on the wire: quantize locally, all-gather the codes and the
    scales, sum the dequantized replicas in rank order (in fp32, cast back
    to ``x``'s dtype)."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    q, scale = compress_int8(x)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale.reshape(1)) for _ in range(n)]
    dist.all_gather(qs, q.contiguous(), group=group)
    dist.all_gather(ss, scale.reshape(1).contiguous(), group=group)
    deq = torch.stack(qs).float() * torch.cat(ss).reshape(
        (-1,) + (1,) * x.dim())
    return deq.sum(0).to(x.dtype)
