"""Shared model-building blocks of the dense, MoE, hybrid and SSM
families and the audio and VLM frontends (port of
``repro/models/common.py``): config, input-shape cell, cache slot layout
and surgery (dense stripes and paged block pools, ring buffers among
them), the conv-state hand-off of a right-padded prefill, the linear
recurrence scan of the recurrent families, norms, RoPE, the chunked
LM-head cross entropy of training, init helpers.

Parameters are nested dicts of tensors with the JAX package's layouts
(linears ``(d_in, d_out)``, stacked ``(L, d_in, d_out)`` over layers), so
weights carry over from the JAX package by a plain copy.  The dense cache
is ``{"k", "v": (L, B, S_max, KV, hd), "len": (B,) int32}``; the paged
cache replaces the ``(B, S_max)`` axes of ``k``/``v`` by ``(n_blocks,
block_size)`` (and under ``kv_quant`` holds codes plus ``k_qscale`` /
``v_qscale`` scale pools).  Unlike the JAX package's immutable arrays,
the port updates cache leaves in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.quantize import fake_quantize_kv, quantize_kv

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "CacheLeafSpec",
    "PagedCacheLeafSpec",
    "reset_cache_slots",
    "merge_cache_slots",
    "scatter_cache_slots",
    "insert_cache_slots",
    "gather_conv_tail",
    "linear_scan",
    "rms_norm",
    "make_rope",
    "apply_rope",
    "fused_cross_entropy",
    "dense_init",
    "embed_init",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of the dense, MoE, hybrid and SSM
    families and the audio and VLM frontends, with the JAX package's field
    names and torch dtypes.

    ``frontend`` stubs a modality frontend on the Transformer: under
    ``"audio_tokens"`` (musicgen) the model takes precomputed frame
    embeddings ``batch["embeds"] (B, S, d_model)`` and has no embedding
    table (``n_codebooks`` is recorded: one EnCodec stream); under
    ``"vision_embeds"`` (pixtral) it takes ``batch["patch_embeds"] (B,
    n_patches, d_model)`` as a prefix before the embedded text tokens.

    The SSM family (Mamba2, ``models/mamba2.py``) reads ``ssm_state`` (the
    state size N of each head), ``ssm_head_dim`` (P), ``ssm_expand`` (the
    inner width over ``d_model``), ``ssm_chunk`` (the chunk length of the
    chunked dual form; a sequence it does not divide takes its largest
    divisor below it) and ``conv_kernel``.

    The hybrid family (Griffin, ``models/griffin.py``) reads
    ``conv_kernel`` (the recurrent block's causal conv taps),
    ``lru_width`` (the RG-LRU width, 0: ``d_model``), ``attn_period``
    (one local-attention layer per that many layers), ``local_window``
    (the attention window and the decode ring's rows) and ``kv_block``
    (the JAX flash kernel's KV tile, recorded: the port's kernel walks
    64-key tiles).  ``seq_parallel_residual`` is the JAX package's
    sequence-parallel residual constraint between macro blocks: a layout
    constraint on an activation, which only a forward over DTensors could
    take.  The port's forwards run on each rank's whole local tensors
    (the sharded engine and the data-parallel step hand every model call
    plain tensors), so it is recorded and changes nothing, as the MoE
    group-axis constraint of the JAX package's ``moe._constrain``.

    The MoE family (``n_experts > 0``: :attr:`is_moe`) routes each token
    to ``top_k`` of ``n_experts`` expert FFNs (``models/moe.py``); a
    training forward keeps ``capacity_factor`` times each expert's fair
    share of tokens (serving never drops), in ``moe_groups`` token groups,
    and the loss adds ``router_aux_weight`` times the summed router aux
    loss.  ``fsdp`` shards the expert stacks' ``d_ff`` over `data` in the
    placement rules (``launch.shardings.param_shardings``); values never
    change.

    ``kv_quant`` ("nf4" | "int8" | None) makes the decode step quantize
    each new K/V row on write (paged pools of codes, or the fake-quantized
    round trip in a dense cache), in blocks of ``quant_block_size``
    elements along head_dim.  ``base_quant`` and ``quant_block_size`` are
    what ``ServingEngine(base_quant=)`` packs the projections with;
    ``kv_cache`` and ``kv_block_size`` describe the serving cache for
    accounting, as in the JAX package (the engine takes its own
    ``cache=`` and ``block_size=``)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # "reference" = plain PyTorch attention; "pallas" = the hand-written
    # CUDA flash kernels (the name is kept so that configs carry over)
    attn_backend: str = "reference"
    # "reference" = adapter protocol in plain PyTorch; "pallas" = QuanTA
    # linears through the hand-written quanta_linear kernel
    peft_backend: str = "reference"
    q_block: int = 512            # query tile of the reference attention
    fast_softmax: bool = False    # reference attention only
    kv_cache: str = "dense"
    kv_block_size: int = 64
    # the dry run's mean share of max_len a paged slot holds (the roofline
    # bills paged decode reads by it: ``launch/roofline.py``)
    kv_occupancy: float = 0.5
    base_quant: Optional[str] = None
    quant_block_size: int = 64
    kv_quant: Optional[str] = None
    quanta_scheme: Optional[str] = None
    # training: recompute each layer's activations in the backward
    # (torch.utils.checkpoint per layer) instead of keeping them
    remat: bool = True
    # the config's gradient accumulation for training (0: the caller's
    # choice); a caller passes it to ``make_train_step(microbatches=)``
    train_microbatches: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_groups: int = 1
    fsdp: bool = False
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (RG-LRU / Griffin); conv_kernel also Mamba2's
    conv_kernel: int = 4
    lru_width: int = 0
    attn_period: int = 3          # 1 attention layer per `period` layers
    local_window: int = 2048
    kv_block: int = 512
    seq_parallel_residual: bool = False
    # modality frontend stubs: None | "audio_tokens" | "vision_embeds"
    frontend: Optional[str] = None
    n_codebooks: int = 1          # audio (EnCodec streams)
    n_patches: int = 0            # vlm: image patch count per example

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: a ``seq_len`` x ``global_batch`` point."""

    name: str                     # train_4k | prefill_32k | decode_32k | ...
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"
    microbatches: int = 1         # gradient-accumulation steps (train only)


# ---------------------------------------------------------------------------
# Decode-cache slot layout and surgery (in place)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheLeafSpec:
    """Slot layout of one decode-cache leaf: the axis indexed by serving
    slot, and the value a freed slot resets to."""

    slot_axis: int
    fill: Any = 0


@dataclasses.dataclass(frozen=True)
class PagedCacheLeafSpec(CacheLeafSpec):
    """A cache leaf with a per-token axis that the paged cache pools.

    ``page_axis`` is the token axis of the dense layout (directly after
    ``slot_axis``).  Under ``ServingEngine(cache="paged")`` the leaf is a
    block pool: the ``(slot, token)`` axes become ``(n_blocks,
    block_size)`` and a host-side block table maps each slot's logical
    blocks to pool rows (``serve/paging.py``).  Pool row 0 is the null
    block: scatter padding and the writes of freed slots land there and
    are never read.

    ``ring=True`` marks a fixed-capacity ring buffer (Griffin's
    local-attention window): the rows in use are ``[0, min(len,
    extent))``, so a slot's blocks stop at ``ceil(extent / block_size)``.

    ``kv_quant`` ("nf4" | "int8" | None) marks a float leaf whose pool
    stores quantized rows: codes under the leaf's key plus a
    ``<key>_qscale`` sibling of fp32 scales per ``quant_block`` elements
    of the last axis.  The commit scatter quantizes wave stripes into
    both; the dense engine writes the fake-quantized round trip into the
    one float leaf instead.  The scale sibling's spec has ``kv_quant=None``.
    """

    page_axis: int = 2
    ring: bool = False
    kv_quant: Optional[str] = None
    quant_block: int = 64


def _slot_index(leaf: torch.Tensor, axis: int, ids) -> list:
    idx = [slice(None)] * leaf.dim()
    idx[axis] = torch.as_tensor(ids, dtype=torch.long, device=leaf.device)
    return idx


def reset_cache_slots(spec: Dict[str, CacheLeafSpec], cache, slot_ids,
                      skip_paged: bool = False):
    """Reset the given slots of every leaf to its spec's fill, in place.
    ``skip_paged`` leaves paged pools alone: freeing their rows is a
    block-table operation, and stale rows are never read."""
    for key, ls in spec.items():
        if skip_paged and isinstance(ls, PagedCacheLeafSpec):
            continue
        leaf = cache[key]
        leaf[tuple(_slot_index(leaf, ls.slot_axis, slot_ids))] = ls.fill
    return cache


def merge_cache_slots(spec: Dict[str, CacheLeafSpec], new_cache, old_cache,
                      active, skip_paged: bool = False):
    """Keep ``new_cache`` stripes only where ``active`` (bool per slot, a
    host array or a tensor on the cache's device).

    The result is written in place into ``new_cache``'s leaves, which the
    returned dict holds, so a caller that keeps those leaves (the decode
    step updates the cache in place, ``len`` included) keeps their
    storage; ``old_cache`` then only needs the leaves to restore, such as
    a copy of ``len`` from before the step.  A leaf that is the same
    tensor in both (updated in place, nothing to restore) is kept as it
    is: the stripes of inactive slots then hold entries past their
    length, which every reader masks and the next admission overwrites.
    ``skip_paged`` takes paged pools from ``new_cache`` as they are: the
    writes of inactive slots landed in the null block.
    """
    out = dict(old_cache)
    for key, ls in spec.items():
        new, old = new_cache[key], old_cache[key]
        out[key] = new
        if new is old or (skip_paged and isinstance(ls, PagedCacheLeafSpec)):
            continue
        act = torch.as_tensor(active, dtype=torch.bool, device=new.device)
        sel = act.reshape(
            (1,) * ls.slot_axis + (-1,) + (1,) * (new.dim() - ls.slot_axis - 1)
        )
        new.copy_(torch.where(sel, new, old))
    return out


def _scatter_paged_leaf(ls: PagedCacheLeafSpec, dst: torch.Tensor,
                        src: torch.Tensor, n: int, tables) -> None:
    """Scatter the token blocks of a wave leaf ``(..., rows, S, ...)``
    into the pool ``dst (..., n_blocks, bs, ...)`` through ``tables (n,
    nb)``, in place; entries past a row's block count name the null
    block, so pad-token garbage lands there."""
    s_ax, p_ax = ls.slot_axis, ls.page_axis
    if p_ax != s_ax + 1:
        raise ValueError("paged leaf needs page_axis == slot_axis + 1")
    tables = torch.as_tensor(tables, dtype=torch.long, device=dst.device)
    nb = tables.shape[1]
    bs = dst.shape[p_ax]
    src = src.narrow(s_ax, 0, n)
    s = src.shape[p_ax]
    if s > nb * bs:
        raise ValueError(f"wave extent {s} exceeds table span {nb * bs}")
    if s < nb * bs:
        shape = list(src.shape)
        shape[p_ax] = nb * bs - s
        src = torch.cat([src, src.new_zeros(shape)], dim=p_ax)
    shp = src.shape
    src = src.reshape(shp[:s_ax] + (n * nb, bs) + shp[p_ax + 1:])
    idx = [slice(None)] * dst.dim()
    idx[s_ax] = tables.reshape(-1)
    dst[tuple(idx)] = src.to(dst.dtype)


def _quantize_wave_leaves(spec: Dict[str, CacheLeafSpec], wave, paged: bool):
    """Quantize-on-commit of ``kv_quant`` leaves: under a paged cache whose
    spec has the ``<key>_qscale`` sibling, the float stripe becomes codes
    (under its key) and scales (under the sibling); otherwise its
    fake-quantized round trip, which the dense engine stores."""
    out = wave
    for key, ls in spec.items():
        if not isinstance(ls, PagedCacheLeafSpec) or ls.kv_quant is None:
            continue
        if out is wave:
            out = dict(wave)
        if paged and key + "_qscale" in spec:
            out[key], out[key + "_qscale"] = quantize_kv(
                out[key], ls.kv_quant, block_size=ls.quant_block)
        else:
            out[key] = fake_quantize_kv(out[key], ls.kv_quant,
                                        block_size=ls.quant_block)
    return out


def scatter_cache_slots(spec: Dict[str, CacheLeafSpec], cache, slot_ids,
                        wave_cache, block_tables=None):
    """Scatter the first ``len(slot_ids)`` slot stripes of ``wave_cache``
    into ``cache`` at ``slot_ids``, in place.  Wave axes shorter than the
    cache are written as a prefix (every reader masks by the slot's
    length).  With ``block_tables (len(slot_ids), nb)`` the paged leaves
    scatter into their pools through the table instead."""
    n = len(slot_ids)
    wave_cache = _quantize_wave_leaves(spec, wave_cache,
                                       paged=block_tables is not None)
    for key, ls in spec.items():
        dst, src = cache[key], wave_cache[key]
        if block_tables is not None and isinstance(ls, PagedCacheLeafSpec):
            _scatter_paged_leaf(ls, dst, src, n, block_tables)
            continue
        ax = ls.slot_axis
        src = src.narrow(ax, 0, n)
        idx = _slot_index(dst, ax, slot_ids)
        for d in range(dst.dim()):
            if d == ax or src.shape[d] == dst.shape[d]:
                continue
            if src.shape[d] > dst.shape[d]:
                src = src.narrow(d, 0, dst.shape[d])
            else:
                idx[d] = slice(0, src.shape[d])
        dst[tuple(idx)] = src.to(dst.dtype)
    return cache


def gather_conv_tail(x: torch.Tensor, lengths: torch.Tensor, window: int
                     ) -> torch.Tensor:
    """The last ``window`` pre-conv inputs of each right-padded row,
    zeros where the prompt is shorter than ``window``: the rolling conv
    state that decode keeps between steps, so a prefill hands decode the
    state it would have built token by token.  ``x (B, S, C)``,
    ``lengths (B,)`` -> ``(B, window, C)``."""
    b, s = x.shape[0], x.shape[1]
    idx = (lengths.to(x.device).long()[:, None] - window
           + torch.arange(window, device=x.device))
    tail = x[torch.arange(b, device=x.device)[:, None],
             torch.clamp(idx, 0, s - 1)]
    return torch.where((idx >= 0)[..., None], tail, torch.zeros_like(tail))


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even[0], odd[0], even[1], ...`` along axis 1; ``even`` holds as
    many entries as ``odd`` or one more."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2)
    out = pairs.reshape(odd.shape[0], 2 * n, *odd.shape[2:])
    if even.shape[1] > n:
        out = torch.cat([out, even[:, n:]], dim=1)
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1 (``h_{-1} = 0``), by the
    recursion of ``jax.lax.associative_scan`` with the combine ``(al, bl),
    (ar, br) -> (al * ar, ar * bl + br)``: adjacent pairs combined, the
    halves scanned, the even positions filled in; so each value is
    rounded as the JAX package rounds it.  ``a`` broadcasts against ``b``
    past axis 1 (Griffin's RG-LRU: both ``(B, S, d)``; Mamba2's chunk
    decays ``(B, nc, H, 1, 1)`` over its ``(B, nc, H, N, P)`` states,
    whose combine ``br + ar * bl`` is the same sum: IEEE addition
    commutes).  Differentiable, static shapes."""

    def combine(al, bl, ar, br):
        return al * ar, ar * bl + br

    def scan(a, b):
        n = b.shape[1]
        if n < 2:
            return a, b
        ra, rb = combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
        oa, ob = scan(ra, rb)
        if n % 2 == 0:
            ea, eb = combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
        else:
            ea, eb = combine(oa, ob, a[:, 2::2], b[:, 2::2])
        ea = torch.cat([a[:, :1], ea], dim=1)
        eb = torch.cat([b[:, :1], eb], dim=1)
        return _interleave(ea, oa), _interleave(eb, ob)

    return scan(a, b)[1]


def insert_cache_slots(spec: Dict[str, CacheLeafSpec], cache, slot_ids,
                       prefill_cache, lengths=None, block_tables=None):
    """``insert_cache`` of every model: :func:`scatter_cache_slots`, with
    ``lengths`` overriding the wave's ``len`` leaf."""
    if lengths is not None:
        prefill_cache = dict(prefill_cache, len=torch.as_tensor(
            lengths, dtype=torch.int32, device=cache["len"].device))
    return scatter_cache_slots(spec, cache, slot_ids, prefill_cache,
                               block_tables)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with fp32 accumulation."""
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * scale.float()).to(x.dtype)


def make_rope(positions: torch.Tensor, head_dim: int, theta: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for integer ``positions (...,)`` -> ``cos/sin (...,
    head_dim//2)`` in fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python scalar base: no host-to-device copy (a decode tick may run
    # inside a captured CUDA graph), the same float32 powers
    freqs = torch.pow(float(theta), exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotary embedding of ``x (B, S, H, hd)`` with tables ``(B, S,
    hd//2)``; pairs are (x[..., :half], x[..., half:])."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x1.dtype)
    s = sin[..., None, :].to(x1.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _chunk_nll(x: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
               vocab_size: int) -> torch.Tensor:
    """Summed NLL of one sequence chunk: its logits ``x @ w_head`` in the
    compute dtype, padded columns set to the dtype's minimum, then fp32
    logsumexp minus the gold logit, over the labels that are not -100."""
    logits = x @ w_head
    col = torch.arange(w_head.shape[-1], device=x.device)
    logits = torch.where(col < vocab_size, logits,
                         torch.finfo(logits.dtype).min).float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(valid, logz - gold, 0.0).sum()


def fused_cross_entropy(
    x: torch.Tensor,            # (B, S, d) final hidden states
    w_head: torch.Tensor,       # (d, V_padded)
    labels: torch.Tensor,       # (B, S); -100 = ignored
    vocab_size: int,            # true vocab (padded columns are masked)
    n_chunks: int = 8,
) -> torch.Tensor:
    """Sequence-chunked LM head plus cross entropy, the mean over valid
    labels in fp32.  The ``(B, S, V)`` logits are never held whole: each
    chunk of ``S / n_chunks`` positions (one chunk when S does not divide)
    runs under ``torch.utils.checkpoint`` when grad is on, so the forward
    keeps no logits and the backward recomputes one chunk's at a time.
    Chunk sums add in order, as the JAX package's scan does."""
    b, s, _ = x.shape
    if s % n_chunks:
        n_chunks = 1
    c = s // n_chunks
    labels = labels.to(x.device)
    remat = torch.is_grad_enabled() and (x.requires_grad
                                         or w_head.requires_grad)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        args = (x[:, i * c:(i + 1) * c], w_head, labels[:, i * c:(i + 1) * c],
                vocab_size)
        if remat:
            nll = torch.utils.checkpoint.checkpoint(_chunk_nll, *args,
                                                    use_reentrant=False)
        else:
            nll = _chunk_nll(*args)
        nll_sum = nll_sum + nll
    n_valid = (labels >= 0).sum()
    return nll_sum / torch.clamp(n_valid, min=1)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std: float, generator: torch.Generator, device
                  ) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0,
                                       generator=generator) * std


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LLaMA-style), drawn in fp32."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _trunc_normal((d_in, d_out), std, generator, device).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return _trunc_normal((vocab, d), 0.02, generator, device).to(dtype)
