"""Shared-memory budget of one thread block, read from the card.

Takes the place of the JAX package's VMEM budget: the QuanTA chain
kernel's row tile, the one tile of the port that depends on the problem
width, is sized here against the block's limit.  The limit and the SM
count come from ``torch.cuda.get_device_properties``, once per device.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch

__all__ = [
    "DeviceLimits",
    "device_limits",
    "chain_stage_words",
    "chain_smem_bytes",
    "chain_rows_per_block",
]


class DeviceLimits(NamedTuple):
    sms: int          # streaming multiprocessors
    smem_block: int   # shared memory one block may opt in to, in bytes


@functools.lru_cache(maxsize=None)
def device_limits(device: torch.device) -> DeviceLimits:
    """The SM count and the per-block shared-memory opt-in limit of a CUDA
    device (above 48 KB a kernel reaches it only as dynamic shared memory,
    after ``cudaFuncSetAttribute``)."""
    props = torch.cuda.get_device_properties(device)
    return DeviceLimits(props.multi_processor_count,
                        props.shared_memory_per_block_optin)


def chain_stage_words(dims_in: Sequence[int],
                      shapes: Sequence[Sequence[int]],
                      pairs: Sequence[Tuple[int, int]]) -> int:
    """32-bit words the chain kernel stages beside its row buffers: the
    largest stage tensor ``T (om, on, im, in)`` in fp32, transposed to
    ``(im*in, om*on)`` with each row padded by one word, and two int
    offset tables as long as the most columns of any stage (a column is
    one index of every axis outside the stage's pair)."""
    cur = list(dims_in)
    t_words = cols = 0
    for (om, on, im, in_), (m, n) in zip(shapes, pairs):
        t_words = max(t_words, im * in_ * (om * on + 1))
        cols = max(cols, math.prod(cur) // (im * in_))
        cur[m], cur[n] = om, on
    return t_words + 2 * cols


def chain_smem_bytes(rows: int, d_max: int, stage_words: int,
                     itemsize: int) -> int:
    """Shared memory of the QuanTA chain kernel for a ``rows`` tile: two
    ping-pong row buffers of the widest register in the activation dtype
    and the staged words of :func:`chain_stage_words`."""
    return 2 * rows * d_max * itemsize + 4 * stage_words


def chain_rows_per_block(d_max: int, stage_words: int, itemsize: int,
                         smem_limit: int, cap: int = 8) -> int:
    """Largest power-of-two row tile (at most ``cap``) whose chain working
    set fits ``smem_limit`` bytes.  At d=4096 in bf16 with a 227 KB limit
    that is 8 rows (128 KB of row buffers plus 67 KB of staged tensor and
    offsets)."""
    rows = cap
    while rows > 1 and chain_smem_bytes(
        rows, d_max, stage_words, itemsize
    ) > smem_limit:
        rows //= 2
    if chain_smem_bytes(rows, d_max, stage_words, itemsize) > smem_limit:
        raise ValueError(
            f"one row of width {d_max} with {stage_words} staged words "
            f"does not fit a block's {smem_limit} bytes of shared memory"
        )
    return rows
