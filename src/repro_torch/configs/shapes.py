"""The assigned input-shape set (port of ``repro/configs/shapes.py``;
identical for all 10 LM-family archs).

``decode_*`` / ``long_*`` lower ``decode_step`` (one new token against a
KV/state cache of ``seq_len``); ``train_4k`` lowers ``train_step``;
``prefill_32k`` lowers ``prefill_step``.

``long_500k`` requires sub-quadratic attention: it RUNS for the SSM/hybrid
archs (mamba2-1.3b, recurrentgemma-2b — O(1)/windowed state) and is
SKIPPED for pure full-attention archs.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.models.common import ShapeConfig

__all__ = ["SHAPES", "shapes_for", "skipped_shapes", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K"]

TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                       kind="train", microbatches=8)
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                         kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                        kind="decode")

SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

# Families whose decode state is sub-quadratic in context length.
_SUBQUADRATIC = ("ssm", "hybrid")


def shapes_for(family: str) -> Tuple[ShapeConfig, ...]:
    if family in _SUBQUADRATIC:
        return SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)


def skipped_shapes(family: str) -> Tuple[ShapeConfig, ...]:
    if family in _SUBQUADRATIC:
        return ()
    return (LONG_500K,)
