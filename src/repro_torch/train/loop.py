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
``lax.scan`` does.

Data parallelism (``dp_axes`` with a ``DeviceMesh``): every rank takes the
same global batch and works on its share of each microbatch's rows (the
JAX step's ``P(None, dp)`` split of the ``(m, b/m)`` microbatches), and
the gradients and the loss are summed over the data axes (one
``all_reduce`` an axis).  Each microbatch's share is weighted by its
valid labels over the microbatch's, so the step computes the single
device's token mean; an MoE model's router aux loss takes the same
weights, which makes it the weighted mean of the shards' aux losses.
``compress`` runs error feedback on the reduced gradient, as on one
device.
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


def _split_microbatches(batch: Dict[str, Any], m: int, share=(0, 1)):
    """``m`` microbatches of ``batch``, in order, along its first axis;
    ``share=(r, n)`` keeps the ``r``-th of ``n`` equal row chunks of
    each."""
    sizes = {len(v) for v in batch.values()}
    for b in sizes:
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        if (b // m) % share[1]:
            raise ValueError(f"microbatch of {b // m} rows does not split "
                             f"over {share[1]} data shards")
    out = []
    for i in range(m):
        mb = {}
        for k, v in batch.items():
            rows = len(v) // m // share[1]
            start = i * (len(v) // m) + share[0] * rows
            mb[k] = v[start:start + rows]
        out.append(mb)
    return out


def _valid(mb) -> torch.Tensor:
    """Valid labels of a microbatch (the loss's token count), a float64
    tensor on the labels' device: the step never reads it back to the
    host."""
    return (torch.as_tensor(mb["labels"]) >= 0).sum().to(torch.float64)


def make_train_step(
    model,
    optimizer: AdamW,
    *,
    microbatches: int = 1,
    compress: bool = False,
    full_ft: bool = False,
    dp_axes: Optional[Tuple[str, ...]] = None,
    mesh=None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """Build ``train_step(state, batch) -> (state, metrics)``; metrics are
    ``loss`` and ``grad_norm`` (0-d fp32 tensors, the norm of the
    gradient AdamW is given, before clipping) and ``step``.  The step is
    functional: it returns a new state and leaves ``state`` as it is.

    ``dp_axes`` (axis names of ``mesh``, a ``DeviceMesh``): data-parallel
    over those axes; each rank passes the same global batch."""
    backend = getattr(getattr(model, "cfg", None), "peft_backend",
                      "reference")
    if backend == "pallas":
        # the QuanTA kernels have no backward (kernels/dispatch.py refuses
        # them under autograd): fail here, where the step is built
        raise ValueError(
            "cfg.peft_backend='pallas' is a forward/serving backend (the "
            "QuanTA kernels have no training backward); build the "
            "training model with peft_backend='reference'")
    share, groups = (0, 1), []
    dp = tuple(a for a in (dp_axes or ()) if mesh is not None
               and a in mesh.mesh_dim_names)
    if dp_axes and mesh is None:
        raise ValueError("dp_axes needs the DeviceMesh they name (mesh=)")
    if dp:
        from repro_torch.launch.mesh import axis_sizes, mesh_coordinate

        # this rank's share: its coordinates on the dp axes, flattened in
        # their order
        sizes, coord = axis_sizes(mesh), mesh_coordinate(mesh)
        rank, n = 0, 1
        for a in dp:
            rank, n = rank * sizes[a] + coord[a], n * sizes[a]
        share = (rank, n)
        groups = [mesh.get_group(a) for a in dp if sizes[a] > 1]

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

    def dp_grads(trainable, frozen, batch):
        """The data-parallel step's loss and gradient: this rank's share
        of each microbatch, weighted by its share of the microbatch's
        valid labels, summed over the data axes."""
        import torch.distributed as dist

        grads = tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), trainable)
        loss = torch.zeros((), dtype=torch.float32)
        for whole, mb in zip(_split_microbatches(batch, microbatches),
                             _split_microbatches(batch, microbatches, share)):
            # the share in float64, cast once to float32 (as a Python
            # float multiplies a float32 tensor)
            w = (_valid(mb) / torch.clamp(_valid(whole), min=1.0)
                 / microbatches).float()
            loss_i, g = grad_fn(trainable, frozen, mb)
            grads = tree_map(lambda a, b: a + b.float() * w, grads, g)
            loss = loss.to(loss_i.device) + loss_i.float() * w
        leaves = tree_leaves(grads) + [loss]
        flat = torch.cat([t.reshape(-1) for t in leaves])
        for group in groups:
            dist.all_reduce(flat, group=group)
        out, at = [], 0
        for t in leaves:
            out.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        # one microbatch keeps the gradient in the leaves' dtype, more sum
        # in fp32, as on one device
        grads = tree_unflatten(grads, [
            o if microbatches > 1 else o.to(t.dtype)
            for o, t in zip(out, tree_leaves(trainable))])
        return out[-1], grads

    def train_step(state: TrainState, batch: Dict[str, Any]):
        trainable = state.params if full_ft else state.peft
        frozen = None if full_ft else state.params
        if dp:
            loss, grads = dp_grads(trainable, frozen, batch)
        elif microbatches == 1:
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
