"""The uniform ``Adapter`` protocol every PEFT method implements (port of
``repro/core/adapters.py``).

* ``apply(x, w, backend)`` -- the full adapted linear for weight ``w``.
* ``delta(x)`` -- the additive update ``x @ dW`` in factored form.
* ``matrix()`` -- the materialized ``(d_in, d_out)`` update.
* ``merge(w)`` -- deployment fold ``W = W0 + dW``.
* ``num_params`` -- trainable parameter count.

Adapters are frozen dataclasses whose tensor fields may carry a leading
layer axis (one adapter per stacked ``(L, d_in, d_out)`` weight);
``layer(l)`` returns the view of one layer.  The frozen base ``w`` is a
dense tensor or a ``core.quantize.QuantizedLinear``; :func:`base_matmul`
takes both.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantize import base_matmul

__all__ = ["Adapter", "base_matmul"]


class Adapter:
    """Protocol base class (mixin; concrete adapters are dataclasses)."""

    def delta(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def matrix(self) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, x: torch.Tensor, w: torch.Tensor,
              backend: str = "reference") -> torch.Tensor:
        raise NotImplementedError

    def merge(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def num_params(self) -> int:
        raise NotImplementedError

    def layer(self, index: int) -> "Adapter":
        """The adapter of one layer of a layer-stacked adapter."""
        def pick(v):
            if isinstance(v, torch.Tensor):
                return v[index]
            if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
                return tuple(t[index] for t in v)
            return v

        return dataclasses.replace(self, **{
            f.name: pick(getattr(self, f.name))
            for f in dataclasses.fields(self)
        })
