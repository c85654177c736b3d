"""Mixture-of-Experts FFN with group-local, gather-only capacity dispatch
(port of ``repro/models/moe.py``).

Each token is routed (in fp32) to its ``top_k`` experts, whose gates are
renormalised over the k.  Every expert takes at most ``cap`` tokens a
group (GShard-style drop, in stable ``(token, k)`` order); serving calls
with ``no_drop=True``, which sizes ``cap`` to hold every token.  The
dispatch is static-shaped: a stable argsort of the flat expert ids and a
``searchsorted`` of each expert's first position give every ``(expert,
slot)`` its source token, so dispatch and combine are gathers into and
out of ``(g, E, cap, d)`` buffers, nothing is read back to the host, and
a decode tick that runs it captures as one CUDA graph.  The expert FFN is
three batched products over those buffers (``torch.matmul``, as the JAX
package's einsums, which reach no Pallas kernel).

Differences from the JAX package, none of which changes a value:
- the top k come from a stable descending sort, which, as
  ``jax.lax.top_k``, picks the lower expert index among equal
  probabilities (``torch.topk`` promises no order among ties);
- the JAX package's ``dp_axes`` sharding constraints (``_constrain``:
  the group axis pinned to the DP axes) are layout constraints on
  activations; the port's forwards hold each rank's plain local tensors,
  never DTensors, so there is nothing to constrain and they are left out.

The router and the experts are frozen in training: gradients reach ``x``
through the gate values (and the router's softmax) and through the
gathers.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

__all__ = ["moe_ffn", "expert_capacity", "top_k_gates", "combine_slot"]


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Tokens an expert holds a group: ``capacity_factor`` times its fair
    share ``n_tokens * top_k / n_experts``, at most ``n_tokens``, rounded
    up to a multiple of 8 (at least 8)."""
    cap = int(math.ceil(n_tokens * top_k * capacity_factor / n_experts))
    cap = min(cap, n_tokens)
    return max(8, ((cap + 7) // 8) * 8)


def top_k_gates(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest router probabilities of each token and their
    expert ids (lower id first among ties), the gates renormalised to sum
    to one (clamped at 1e-9)."""
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    gates = torch.gather(probs, -1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def combine_slot(flat_e: torch.Tensor, rank: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """The row of ``(E * cap)`` output rows that holds each assignment:
    its expert's block, at its rank (clamped; a rank past ``cap`` is a
    dropped assignment, whose gate the combine zeroes)."""
    return flat_e * cap + torch.clamp(rank, max=cap - 1)


def moe_ffn(
    x: torch.Tensor,                 # (B, S, d)
    params: Dict[str, torch.Tensor],
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    no_drop: bool = False,
    groups: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output (B, S, d), aux_loss)``: ``params`` holds
    ``router (d, E)`` and the expert stacks ``gate_proj``, ``up_proj``
    ``(E, d, ff)`` and ``down_proj (E, ff, d)``.  ``aux_loss`` is the
    Switch load-balancing loss over all tokens, fp32.  Tokens split into
    ``groups`` groups (1 when that does not divide B * S), each
    dispatched on its own."""
    b, s, d = x.shape
    t = b * s
    e, k = n_experts, top_k
    if no_drop:
        capacity_factor = n_experts / max(top_k, 1)
    g = groups if (groups > 0 and t % groups == 0) else 1
    tg = t // g
    cap = expert_capacity(tg, e, k, capacity_factor)
    n = tg * k
    dev = x.device
    xf = x.reshape(g, tg, d)

    # --- routing (fp32) ---
    logits = xf.float() @ params["router"].float()             # (g,tg,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_gates(probs, k)              # (g,tg,k)

    # Switch aux loss: E * sum_e f_e * p_e (over all tokens)
    experts = torch.arange(e, device=dev)
    top1 = (expert_idx[..., 0, None] == experts).float()
    aux_loss = e * torch.sum(top1.mean((0, 1)) * probs.mean((0, 1)))

    # --- group-local sort dispatch (double argsort; gathers only) ---
    flat_e = expert_idx.reshape(g, n)                          # (g,N)
    flat_gate = gate_vals.reshape(g, n).to(x.dtype)
    order = torch.argsort(flat_e, dim=-1, stable=True)         # (g,N)
    sorted_e = torch.gather(flat_e, -1, order)
    bounds = torch.arange(e + 1, device=dev).expand(g, e + 1).contiguous()
    first = torch.searchsorted(sorted_e, bounds)               # (g,E+1)

    # (expert, slot) -> source assignment (gather from `order`)
    pos = first[:, :-1, None] + torch.arange(cap, device=dev)  # (g,E,cap)
    valid = pos < first[:, 1:, None]
    pos_flat = torch.clamp(pos, max=n - 1).reshape(g, e * cap)
    src_token = torch.gather(order, -1, pos_flat) // k         # (g,E*cap)

    buf = torch.gather(xf, 1, src_token[..., None].expand(g, e * cap, d))
    buf = torch.where(valid.reshape(g, e * cap, 1), buf, 0)
    buf = buf.reshape(g, e, cap, d)

    # --- expert FFN: batched products over (group, expert) ---
    h = F.silu(buf @ params["gate_proj"]) * (buf @ params["up_proj"])
    out_buf = (h @ params["down_proj"]).reshape(g, e * cap, d)

    # --- combine (gathers only): assignment -> its capacity slot ---
    inv = torch.argsort(order, dim=-1, stable=True)            # (g,N)
    rank = inv - torch.gather(first[:, :-1], -1, flat_e)
    kept = rank < cap
    slot = combine_slot(flat_e, rank, cap)                     # (g,N)
    contrib = torch.gather(out_buf, 1, slot[..., None].expand(g, n, d))
    contrib = contrib * torch.where(kept, flat_gate, 0)[..., None]
    out = contrib.reshape(g, tg, k, d).sum(dim=2)
    return out.reshape(b, s, d), aux_loss
