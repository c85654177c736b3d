"""Train-step builder (port of ``repro/train/loop.py``): PEFT-aware,
microbatched, with optional int8 error-feedback compression.

The gradient is taken only with respect to the trainable tree: the
adapter set for QuanTA/LoRA/..., the whole param dict under ``full_ft``.
Each step hands fresh leaves of that tree to ``torch.autograd.grad``; the
base weights never require grad, so autograd builds no weight gradient
for them (the JAX step's ``stop_gradient``).  A fold-free QuanTA
adapter's frozen copy S is a leaf of the tree and gets a zero gradient
(it is detached where it is applied), as in the JAX step.

The step runs eagerly (there is no ``jit``).  Microbatch gradients are
summed in fp32 in order, then scaled by ``1 / m``, as the JAX step's
``lax.scan`` does.  ``dp_axes`` (the data-parallel mesh axes) waits for
the mesh slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch

from repro_torch.core.adapters import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.optim.compress import (
    ErrorFeedbackState, ef_compress_grads, ef_init,
)

__all__ = ["TrainState", "make_train_step", "make_eval_step"]


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any                 # frozen base weights (S folded in, or not)
    peft: Any                   # trainable adapter set ({} for full FT)
    opt_state: AdamWState
    ef_state: Optional[ErrorFeedbackState]
    step: int
    # the checkpoint store writes ``step`` as a 0-d int32 leaf, as the
    # JAX package holds it
    int_leaves: ClassVar[Tuple[str, ...]] = ("step",)

    @staticmethod
    def create(params, peft, optimizer: AdamW, *, compress: bool = False,
               full_ft: bool = False) -> "TrainState":
        trainable = params if full_ft else peft
        return TrainState(
            params=params, peft=peft, opt_state=optimizer.init(trainable),
            ef_state=ef_init(trainable) if compress else None, step=0,
        )


def _split_microbatches(batch: Dict[str, Any], m: int):
    """``m`` microbatches of ``batch``, in order, along its first axis."""
    sizes = {len(v) for v in batch.values()}
    for b in sizes:
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
    return [{k: v[i * (len(v) // m):(i + 1) * (len(v) // m)]
             for k, v in batch.items()} for i in range(m)]


def make_train_step(
    model,
    optimizer: AdamW,
    *,
    microbatches: int = 1,
    compress: bool = False,
    full_ft: bool = False,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """Build ``train_step(state, batch) -> (state, metrics)``; metrics are
    ``loss`` and ``grad_norm`` (0-d fp32 tensors, the norm of the
    gradient AdamW is given, before clipping) and ``step``.  The step is
    functional: it returns a new state and leaves ``state`` as it is."""
    backend = getattr(getattr(model, "cfg", None), "peft_backend",
                      "reference")
    if backend == "pallas":
        # the QuanTA kernels have no backward (kernels/dispatch.py refuses
        # them under autograd): fail here, where the step is built
        raise ValueError(
            "cfg.peft_backend='pallas' is a forward/serving backend (the "
            "QuanTA kernels have no training backward); build the "
            "training model with peft_backend='reference'")

    def grad_fn(trainable, frozen, mb):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(trainable)]
        tree = tree_unflatten(trainable, leaves)
        with torch.enable_grad():
            loss = (model.loss(tree, {}, mb) if full_ft
                    else model.loss(frozen, tree, mb))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), tree_unflatten(trainable, [
            torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)])

    def train_step(state: TrainState, batch: Dict[str, Any]):
        trainable = state.params if full_ft else state.peft
        frozen = None if full_ft else state.params
        if microbatches == 1:
            loss, grads = grad_fn(trainable, frozen, batch)
        else:
            grads = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                   device=x.device),
                             trainable)
            loss = None
            for mb in _split_microbatches(batch, microbatches):
                loss_i, g = grad_fn(trainable, frozen, mb)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss_i if loss is None else loss + loss_i
            inv = 1.0 / microbatches
            grads = tree_map(lambda g: g * inv, grads)
            loss = loss * inv

        ef_state = state.ef_state
        if compress:
            grads, ef_state = ef_compress_grads(grads, ef_state)
        new_trainable, new_opt = optimizer.update(grads, state.opt_state,
                                                  trainable)
        metrics = {"loss": loss, "grad_norm": global_norm(grads),
                   "step": state.step + 1}
        return TrainState(
            params=new_trainable if full_ft else state.params,
            peft=state.peft if full_ft else new_trainable,
            opt_state=new_opt, ef_state=ef_state, step=state.step + 1,
        ), metrics

    return train_step


def make_eval_step(model, *, full_ft: bool = False):
    """``eval_step(state, batch) -> loss`` (no gradient)."""
    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        if full_ft:
            return model.loss(state.params, {}, batch)
        return model.loss(state.params, state.peft, batch)

    return eval_step
