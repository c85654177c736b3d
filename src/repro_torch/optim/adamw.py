"""AdamW (port of ``repro/optim/adamw.py``).

The optimizer takes whatever tree it is given: a nested dict of tensors,
an ``AdapterSet`` or an adapter (anything ``core.adapters.tree_map``
walks).  For PEFT runs that is the adapter tree only, so first and second
moments exist only for the trainable tensors (paper §6).

The arithmetic is the JAX package's: fp32 moments, bias correction from
the step counter, decoupled decay on the fp32 params, the result cast back
to each param's dtype.  The step is a plain Python int and the learning
rate a Python float of it (``optim/schedules.py``), rounded to fp32 where
it meets a tensor.  ``update`` is functional: it returns new params and a
new state and leaves its arguments as they are (no tensor is updated in
place), as the JAX update does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.adapters import (
    tree_leaves, tree_map, tree_unflatten,
)

__all__ = ["AdamW", "AdamWState", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: int
    mu: Any
    nu: Any
    # the checkpoint store writes ``step`` as a 0-d int32 leaf
    int_leaves: ClassVar[Tuple[str, ...]] = ("step",)


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor of ``tree``, in fp32
    (a 0-d tensor; 0 for an empty tree)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``tree`` scaled by ``min(1, max_norm / norm)``; returns it and the
    norm before clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``AdamW(lr).init(params)`` -> state; ``update(grads, state,
    params)`` -> ``(new_params, new_state)``.  ``lr`` is a float or a
    schedule (a function of the step, 1 at the first update)."""

    lr: Union[Callable[[int], float], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0

    def init(self, params: Any) -> AdamWState:
        zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)  # noqa: E731
        return AdamWState(step=0, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def _lr(self, step: int) -> np.float32:
        return np.float32(self.lr(step) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> Tuple[Any, AdamWState]:
        if self.max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, self.max_grad_norm)
        step = state.step + 1
        lr = float(self._lr(step))
        b1, b2 = self.b1, self.b2
        # fp32 bias corrections, as the JAX update computes them
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))

        def upd(g, m, v, p):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = []
        tree_map(lambda p, g, m, v: out.append(upd(g, m, v, p)),
                 params, grads, state.mu, state.nu)
        new_p, new_m, new_v = (tree_unflatten(params, leaves)
                               for leaves in zip(*out))
        return new_p, AdamWState(step=step, mu=new_m, nu=new_v)
