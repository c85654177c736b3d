"""LR schedules (port of ``repro/optim/schedules.py``): linear warmup and
decay (the paper's choice), warmup-stable-decay (MiniCPM) and constant.

Each schedule is a function of the integer step that returns a Python
float.  The arithmetic runs on numpy float32 scalars, one rounding per
operation in the JAX schedules' order, so the rates equal theirs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["linear_warmup_schedule", "wsd_schedule", "constant_schedule"]

_F = np.float32


def constant_schedule(lr: float):
    return lambda step: float(_F(lr))


def linear_warmup_schedule(lr: float, total_steps: int, warmup_steps: int = 0):
    """Linear warmup then linear decay to 0 (paper Tables E.2-E.4)."""

    def fn(step):
        step = _F(step)
        warm = min(step / _F(max(warmup_steps, 1)), _F(1.0))
        frac = np.clip((_F(total_steps) - step)
                       / _F(max(total_steps - warmup_steps, 1)),
                       _F(0.0), _F(1.0))
        return float(_F(lr) * (warm if step < warmup_steps else frac))

    return fn


def wsd_schedule(lr: float, total_steps: int, warmup_steps: int,
                 decay_steps: int, floor: float = 0.0):
    """Warmup -> stable plateau -> linear decay over the last
    ``decay_steps`` (MiniCPM)."""

    def fn(step):
        step = _F(step)
        warm = step / _F(max(warmup_steps, 1))
        decay_start = _F(total_steps - decay_steps)
        decay = _F(1.0) - _F(1.0 - floor) * np.clip(
            (step - decay_start) / _F(max(decay_steps, 1)), _F(0.0), _F(1.0))
        if step < warmup_steps:
            mult = warm
        elif step < decay_start:
            mult = _F(1.0)
        else:
            mult = decay
        return float(_F(lr) * mult)

    return fn
