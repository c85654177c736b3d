"""Pipeline parallelism (port of ``repro/train/pipeline.py``): a GPipe
microbatch pipeline over a mesh ``stage`` axis, on ``torch.distributed``.

Each stage holds ``L / P`` contiguous layers of the ``(L, ...)`` stack.
The rotation runs ``T = M + P - 1`` ticks: at tick ``t`` stage ``s``
works on microbatch ``t - s``, and the activations move one stage on by
point-to-point send/recv in a ring (:class:`_Shift`, the JAX package's
``ppermute``).  The move is an ``autograd.Function`` whose backward sends
the gradient the other way, so a loss differentiates through the whole
pipeline (GPipe's backward).  The last stage's outputs are broadcast to
every stage.

Bubble fraction ``(P - 1) / (M + P - 1)``: :func:`bubble_fraction`.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.adapters import tree_leaves, tree_map

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_microbatches: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _exchange(send: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``send`` to global rank ``to`` and receive a tensor of its
    shape from ``frm``, as one batch of point-to-point ops."""
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _Shift(torch.autograd.Function):
    """Every stage's tensor to the next stage (ring); the backward sends
    each gradient back to the stage it came from."""

    @staticmethod
    def forward(ctx, y, nxt, prv, group):
        ctx.peers = (nxt, prv, group)
        return _exchange(y, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        nxt, prv, group = ctx.peers
        return _exchange(g, prv, nxt, group), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every stage (a broadcast); every stage
    computes the same loss from it, so the backward hands the last stage
    its own gradient and the others nothing."""

    @staticmethod
    def forward(ctx, t, src, is_last, group):
        ctx.is_last = is_last
        out = t.detach().clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else torch.zeros_like(g)), None, None, None


def pipeline_apply(
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x_mbs: torch.Tensor,
    *,
    mesh,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Run ``x`` through the whole layer stack, pipelined over stages.

    ``layer_fn(layer_params, h) -> h`` applies ONE layer.
    ``stacked_params``: leaves ``(L, ...)`` (every rank holds them whole),
    ``L`` divisible by the stage count; a stage reads its own ``L / P``
    layers, so each leaf's gradient lands on the stage owning each layer
    (zeros elsewhere: sum over the stage axis for the whole gradient).
    ``x_mbs``: ``(M, mb, ...)`` microbatches, the same on every rank.
    Returns the ``(M, mb, ...)`` outputs on every rank.
    """
    from repro_torch.launch.mesh import axis_sizes, mesh_coordinate

    n_stages = axis_sizes(mesh)[stage_axis]
    s = mesh_coordinate(mesh)[stage_axis]
    m_total = x_mbs.shape[0]
    n_ticks = m_total + n_stages - 1
    group = mesh.get_group(stage_axis)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(s + 1) % n_stages], ranks[(s - 1) % n_stages]
    n_layers = {t.shape[0] for t in tree_leaves(stacked_params)}.pop()
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over "
                         f"{n_stages} stages")
    per = n_layers // n_stages
    local = tree_map(lambda t: t[s * per:(s + 1) * per], stacked_params)

    def apply_local(h):
        for i in range(per):
            h = layer_fn(tree_map(lambda t: t[i], local), h)
        return h

    def shift(y):
        if n_stages == 1:
            return y
        return _Shift.apply(y, nxt, prv, group)

    h_recv = torch.zeros_like(x_mbs[0])
    outputs = [torch.zeros_like(x_mbs[0]) for _ in range(m_total)]
    for t in range(n_ticks):
        x_first = x_mbs[min(t, m_total - 1)]
        # stage 0 reads its input, not the ring; the 0 * keeps every
        # shift on every stage's graph, so the backward exchanges pair up
        x_in = x_first + 0 * h_recv if s == 0 else h_recv
        y = apply_local(x_in)
        m = t - s
        if s == n_stages - 1 and 0 <= m < m_total:
            outputs[m] = y
        h_recv = shift(y)
    out = torch.stack(outputs) + 0 * h_recv
    if n_stages == 1:
        return out
    return _FromLast.apply(out, ranks[-1], s == n_stages - 1, group)
