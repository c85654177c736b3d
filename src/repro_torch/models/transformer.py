"""Decoder-only transformer: the dense and MoE families and the audio
and VLM frontends (port of ``repro/models/transformer.py``).

Parameters are the JAX package's nested dict with layer-stacked leaves
(``params["layers"]`` leaves have leading dim L); the layer loop takes
views ``w[l]`` where the JAX package scans.  PEFT adapters are stacked
the same way and sliced in lockstep; an adapter bank (``core/bank.py``)
takes per-request ``adapter_ids`` in ``prefill`` and ``decode_step``.  A
projection may be a ``QuantizedLinear`` (``core/quantize.py``),
layer-stacked like the dense weight it replaces.  Serving updates the
decode cache in place: a dense cache, or paged block pools addressed
through per-slot block tables (of rows, or of NF4/int8 codes under
``cfg.kv_quant``).  Training takes :meth:`Transformer.loss`: the
backbone with one ``torch.utils.checkpoint`` per layer under
``cfg.remat``, then the chunked LM-head cross entropy; it runs with grad,
while ``forward``, ``prefill`` and ``decode_step`` run under
``torch.no_grad()``.  Chunked prefill (:meth:`Transformer.prefill_chunk`)
stages one prompt a fixed-size chunk at a time in a dense staging cache.
Tensor parallelism over `model` (``tp=``, a
``models.tensor_parallel.ModelGroup``; the dense and frontend families):
``params`` are this rank's shards by the JAX decode rules
(``launch.shardings.local_params``) and the layers run Megatron style on
plain local tensors -- q/k/v and gate/up column-parallel (``n_heads / m``
and ``n_kv_heads / m`` whole local heads, so the GQA map stays local),
o_proj and down_proj row-parallel with one ``all_reduce`` each, the
d_model-sharded table looked up locally and ``all_gather``-ed, the tied
head's partial logits ``all_reduce``-d and an untied head's vocab
columns ``all_gather``-ed: every rank holds the whole logits.  The cache
holds the rank's KV heads.
The MoE family (mixtral, llama4) replaces each layer's MLP by
``models/moe.moe_ffn`` over the layer-stacked router ``(L, d, E)`` and
expert stacks ``(L, E, d, ff)``; serving (decode, a chunk, a prefill
with ``lengths``) never drops a token, while ``forward``, ``loss`` and a
prefill without ``lengths`` keep the training dispatch, and ``loss``
adds ``router_aux_weight`` times the aux loss summed over layers.
The frontends are stubs, as in the JAX package: an ``audio_tokens``
model (musicgen) has no embedding table and reads precomputed frame
embeddings, ``batch["embeds"] (B, S, d)`` (``(B, 1, d)`` in
``decode_step``); a ``vision_embeds`` model (pixtral) reads
``batch["patch_embeds"] (B, n_patches, d)`` as a prefix before its
embedded ``batch["tokens"]`` in ``forward``, ``loss`` and ``prefill``,
and tokens alone in ``decode_step`` and ``prefill_chunk``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.peft import (
    adapter_subtree, get_adapter, layer_tree, peft_linear, sharded_linear,
)
from repro_torch.core.quantize import fake_quantize_kv, quantize_kv
from repro_torch.kernels.dispatch import default_device, seeded_generator
from repro_torch.models.attention import (
    blockwise_causal_attention, chunk_attention, decode_attention,
    local_paged_decode,
    paged_decode_attention,
)
from repro_torch.models.common import (
    CacheLeafSpec,
    ModelConfig,
    PagedCacheLeafSpec,
    apply_rope,
    dense_init,
    embed_init,
    fused_cross_entropy,
    insert_cache_slots,
    make_rope,
    rms_norm,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.tensor_parallel import ONE

__all__ = ["Transformer", "padded_vocab"]


def padded_vocab(vocab: int) -> int:
    """Pad vocab to a multiple of 128 (the JAX package's layout)."""
    return ((vocab + 127) // 128) * 128


class Transformer(nn.Module):
    """Decoder-only transformer of the dense, MoE, audio and VLM families
    (``build_model`` gives Griffin and Mamba2 for the hybrid and SSM
    ones), whose methods take the params dict (the JAX package's
    functional layout, so weights carry over by a copy).

    Runs on ``device`` (default: the card; raises when there is none).
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family == "hybrid":
            raise ValueError("the hybrid family is Griffin (build_model)")
        if cfg.family == "ssm":
            raise ValueError("the ssm family is Mamba2 (build_model)")
        if cfg.family not in ("dense", "moe", "audio", "vlm"):
            raise ValueError(f"unknown model family {cfg.family!r}")
        self.cfg = cfg
        self.device = default_device(device)

    def _linear(self, x, w, adapter=None, bias=None, kind=None, tp=ONE):
        """The adapted linear; under ``tp`` of more than one rank on this
        rank's shard (``kind``: "col" or "row")."""
        if tp.size == 1:
            return peft_linear(x, w, adapter, bias,
                               backend=self.cfg.peft_backend)
        return sharded_linear(x, w, adapter, bias, self.cfg.peft_backend,
                              tp, kind)

    def _heads(self, tp=ONE):
        """``(query heads, KV heads)`` this rank holds under ``tp``."""
        cfg = self.cfg
        return (tp.local(cfg.n_heads, "n_heads"),
                tp.local(cfg.n_kv_heads, "n_kv_heads"))

    # ------------------------------------------------------------------ init
    def init(self, seed) -> Dict[str, Any]:
        """Random weights from ``seed`` (an int or a ``torch.Generator`` on
        the model's device), drawn in fp32 layer by layer (MoE experts
        expert by expert) and stored in ``cfg.param_dtype``."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.param_dtype
        gen = seeded_generator(seed, dev)
        L = cfg.n_layers
        vpad = padded_vocab(cfg.vocab_size)
        d, ad, kvd, ff = cfg.d_model, cfg.attn_dim, cfg.kv_dim, cfg.d_ff

        # a ``meta`` tree holds shapes alone: no draws to make
        draws = torch.device(dev).type != "meta"

        def stack(d_in, d_out):
            out = torch.empty((L, d_in, d_out), dtype=dt, device=dev)
            for i in range(L if draws else 0):
                out[i] = dense_init(gen, d_in, d_out, dt, dev)
            return out

        attn = {
            "q_proj": stack(d, ad),
            "k_proj": stack(d, kvd),
            "v_proj": stack(d, kvd),
            "o_proj": stack(ad, d),
        }
        if cfg.qkv_bias:
            attn["q_bias"] = torch.zeros((L, ad), dtype=dt, device=dev)
            attn["k_bias"] = torch.zeros((L, kvd), dtype=dt, device=dev)
            attn["v_bias"] = torch.zeros((L, kvd), dtype=dt, device=dev)

        def experts(d_in, d_out):
            e = cfg.n_experts
            out = torch.empty((L, e, d_in, d_out), dtype=dt, device=dev)
            for i in range(L if draws else 0):
                for j in range(e):
                    out[i, j] = dense_init(gen, d_in, d_out, dt, dev)
            return out

        layers = {
            "attn": attn,
            "ln1": torch.ones((L, d), dtype=dt, device=dev),
            "ln2": torch.ones((L, d), dtype=dt, device=dev),
        }
        if cfg.is_moe:
            layers["moe"] = {
                "router": stack(d, cfg.n_experts),
                "gate_proj": experts(d, ff),
                "up_proj": experts(d, ff),
                "down_proj": experts(ff, d),
            }
        else:
            layers["mlp"] = {
                "gate_proj": stack(d, ff),
                "up_proj": stack(d, ff),
                "down_proj": stack(ff, d),
            }
        params: Dict[str, Any] = {
            "layers": layers,
            "final_norm": torch.ones((d,), dtype=dt, device=dev),
        }
        # audio backbone: the frontend stub gives frame embeddings, no table
        if cfg.frontend != "audio_tokens":
            params["embed"] = {"tokens": embed_init(gen, vpad, d, dt, dev)}
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, d, vpad, dt, dev)
        return params

    # ------------------------------------------------------------- embedding
    def _tokens(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["tokens"], dtype=torch.long,
                               device=self.device)

    def _embed(self, params, batch, tp=ONE) -> torch.Tensor:
        """The input sequence ``(B, S, d)`` in the compute dtype: frame
        embeddings (audio), ``[patch_embeds ; embedded tokens]`` (vision;
        the patches cast to the table's dtype before the concatenation,
        as in the JAX package) or embedded tokens."""
        cfg = self.cfg
        if cfg.frontend == "audio_tokens":
            return self._input(batch, "embeds").to(cfg.compute_dtype)
        tok = self._table(params, batch, tp)
        if cfg.frontend == "vision_embeds":
            patches = self._input(batch, "patch_embeds").to(tok.dtype)
            tok = torch.cat([patches, tok], dim=1)
        return tok.to(cfg.compute_dtype)

    def _input(self, batch, key) -> torch.Tensor:
        return torch.as_tensor(batch[key], device=self.device)

    def _table(self, params, batch, tp=ONE) -> torch.Tensor:
        """``batch["tokens"]`` looked up in the embedding table (under
        ``tp`` this rank's d_model columns, then gathered)."""
        return tp.all_gather(params["embed"]["tokens"][self._tokens(batch)])

    def _unembed(self, params, x: torch.Tensor, tp=ONE) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_embeddings:
            table = params["embed"]["tokens"].to(cfg.compute_dtype)
            if tp.size > 1:
                off, n = tp.span(table.shape[-1])
                return tp.all_reduce(x[..., off:off + n] @ table.T)
            return x @ table.T
        return tp.all_gather(x @ params["lm_head"].to(cfg.compute_dtype))

    # ------------------------------------------------------------ layer body
    def _attn(self, lp, la, x, *, rope, window, cache=None, chunk=None,
              mesh=None, tp=ONE):
        """Attention sub-block.  ``cache`` for decode is ``(k_cache,
        v_cache, cache_len)`` (dense), ``(k_pool, v_pool, cache_len,
        block_tables)`` (paged) or ``(k_codes, k_scales, v_codes, v_scales,
        cache_len, block_tables)`` (paged, quantized): the new token's K/V
        are written in place at position ``cache_len - 1`` (in a paged pool
        at row ``idx % bs`` of block ``table[b, idx // bs]``, quantized on
        write under ``kv_quant``), then attended.  ``chunk=(k_stage,
        v_stage, rows, q_pos)`` is one chunked-prefill piece: its K/V are
        written in place at staging rows ``rows`` and its queries (at
        absolute positions ``q_pos``, which ``rope`` carries) attend over
        the whole staging buffer.  ``mesh`` (paged, a data-sharded engine):
        ``x`` and the pools are this data rank's slots and arena, the
        tables name global pool rows, and the write and the decode read
        the arena through them (``attention.local_paged_decode``).
        ``tp``: this rank's heads of q, k, v and the cache.
        Returns ``(out, new_kv)``."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv = self._heads(tp)
        q = self._linear(x, lp["q_proj"], get_adapter(la, "q_proj"),
                         lp.get("q_bias"), "col", tp)
        k = self._linear(x, lp["k_proj"], get_adapter(la, "k_proj"),
                         lp.get("k_bias"), "col", tp)
        v = self._linear(x, lp["v_proj"], get_adapter(la, "v_proj"),
                         lp.get("v_bias"), "col", tp)
        q = q.reshape(b, s, h, cfg.head_dim)
        k = k.reshape(b, s, kv, cfg.head_dim)
        v = v.reshape(b, s, kv, cfg.head_dim)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if chunk is not None:
            k_stage, v_stage, rows, q_pos = chunk
            k_stage.index_copy_(1, rows, k.to(k_stage.dtype))
            v_stage.index_copy_(1, rows, v.to(v_stage.dtype))
            out = chunk_attention(q, k_stage, v_stage, q_pos, window=window,
                                  fast_softmax=cfg.fast_softmax)
            new_kv = (k_stage, v_stage)
        elif cache is None:
            out = blockwise_causal_attention(
                q, k, v, q_block=cfg.q_block, window=window,
                fast_softmax=cfg.fast_softmax, backend=cfg.attn_backend,
            )
            new_kv = (k, v)
        elif len(cache) == 3:
            k_cache, v_cache, cache_len = cache
            idx = (cache_len - 1).long()
            b_idx = torch.arange(b, device=x.device)
            k_w, v_w = k[:, 0], v[:, 0]
            if cfg.kv_quant is not None:
                # the dense reference of the quantized pools stores the
                # quantize-dequantize round trip
                k_w = fake_quantize_kv(k_w, cfg.kv_quant,
                                       block_size=cfg.quant_block_size)
                v_w = fake_quantize_kv(v_w, cfg.kv_quant,
                                       block_size=cfg.quant_block_size)
            k_cache[b_idx, idx] = k_w.to(k_cache.dtype)
            v_cache[b_idx, idx] = v_w.to(v_cache.dtype)
            out = decode_attention(
                q, k_cache, v_cache, cache_len, window=window,
                fast_softmax=cfg.fast_softmax, backend=cfg.attn_backend,
            )
            new_kv = (k_cache, v_cache)
        else:
            *pools, cache_len, bt = cache
            bs = pools[0].shape[1]
            idx = (cache_len - 1).long()
            row = idx % bs
            blk = bt[torch.arange(b, device=x.device), idx // bs].long()
            if mesh is not None:
                from repro_torch.launch.mesh import dp_index

                blk = blk - dp_index(mesh) * pools[0].shape[0]
            if len(pools) == 2:
                rows = (k[:, 0], v[:, 0])
                quant = {}
            else:
                qb = cfg.quant_block_size
                kc, ks = quantize_kv(k[:, 0], cfg.kv_quant, block_size=qb)
                vc, vs = quantize_kv(v[:, 0], cfg.kv_quant, block_size=qb)
                rows = (kc, ks, vc, vs)
                quant = dict(kv_quant=cfg.kv_quant, k_scales=pools[1],
                             v_scales=pools[3], quant_block=qb,
                             value_dtype=cfg.param_dtype)
            for pool, r in zip(pools, rows):
                pool[blk, row] = r.to(pool.dtype)
            k_pool, v_pool = (pools[0], pools[2]) if quant else pools
            decode = (paged_decode_attention if mesh is None else
                      functools.partial(local_paged_decode, mesh=mesh))
            out = decode(
                q, k_pool, v_pool, bt, cache_len,
                window=window, fast_softmax=cfg.fast_softmax,
                backend=cfg.attn_backend, **quant,
            )
            new_kv = tuple(pools)
        out = out.reshape(b, s, h * cfg.head_dim)
        out = self._linear(out, lp["o_proj"], get_adapter(la, "o_proj"),
                           None, "row", tp)
        return out, new_kv

    def _mlp(self, lp, la, x, tp=ONE):
        g = self._linear(x, lp["gate_proj"], get_adapter(la, "gate_proj"),
                         None, "col", tp)
        u = self._linear(x, lp["up_proj"], get_adapter(la, "up_proj"),
                         None, "col", tp)
        return self._linear(F.silu(g) * u, lp["down_proj"],
                            get_adapter(la, "down_proj"), None, "row", tp)

    def _layer(self, lp, la, x, *, rope, cache=None, chunk=None,
               no_drop=None, mesh=None, tp=ONE):
        """One layer: ``(x, aux, new_kv)``; ``aux`` is the MoE router's aux
        loss (0.0 for the dense family).  ``no_drop`` (MoE) defaults to
        serving's rule: a cache or a chunk never drops a token."""
        cfg = self.cfg
        h, new_kv = self._attn(
            lp["attn"], la.get("attn", {}),
            rms_norm(x, lp["ln1"], cfg.norm_eps),
            rope=rope, window=cfg.sliding_window, cache=cache, chunk=chunk,
            mesh=mesh, tp=tp,
        )
        x = x + h
        hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if not cfg.is_moe:
            out = self._mlp(lp["mlp"], la.get("mlp", {}), hn, tp)
            return x + out, 0.0, new_kv
        if no_drop is None:
            no_drop = cache is not None or chunk is not None
        out, aux = moe_ffn(hn, lp["moe"], n_experts=cfg.n_experts,
                           top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           no_drop=no_drop, groups=cfg.moe_groups)
        return x + out, aux, new_kv

    def _layers(self, params, peft, adapter_ids=None):
        """``(layer params, layer adapters)`` views, layer by layer; a bank
        selects each row's adapter by ``adapter_ids``."""
        adapters = adapter_subtree(peft, "layers", adapter_ids)
        for i in range(self.cfg.n_layers):
            yield i, layer_tree(params["layers"], i), layer_tree(adapters, i)

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, params, batch, peft=None):
        """Full-sequence forward: ``(logits, aux)``; ``aux`` is the MoE
        aux loss summed over layers (0.0 for the dense family)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        s = x.shape[1]
        rope = make_rope(torch.arange(s, device=x.device)[None, :],
                         cfg.head_dim, cfg.rope_theta)
        aux = 0.0
        for _, lp, la in self._layers(params, peft):
            x, aux_i, _ = self._layer(lp, la, x, rope=rope)
            aux = aux + aux_i
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x), aux

    # ----------------------------------------------------------------- train
    def _hidden(self, params, batch, peft=None):
        """Backbone only: the final-norm hidden states ``(B, S, d)`` and
        the aux loss summed over layers (0.0 for the dense family).  Under
        ``cfg.remat`` (with grad on) each layer runs under
        ``torch.utils.checkpoint``: only its input is kept, and its
        activations are recomputed in the backward."""
        cfg = self.cfg
        x = self._embed(params, batch)
        rope = make_rope(torch.arange(x.shape[1], device=x.device)[None, :],
                         cfg.head_dim, cfg.rope_theta)
        remat = cfg.remat and torch.is_grad_enabled()
        aux = 0.0
        for _, lp, la in self._layers(params, peft):
            def body(h, lp=lp, la=la):
                return self._layer(lp, la, h, rope=rope)[:2]

            x, aux_i = (torch.utils.checkpoint.checkpoint(
                body, x, use_reentrant=False) if remat else body(x))
            aux = aux + aux_i
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def head_weight(self, params) -> torch.Tensor:
        """The LM head ``(d, V_padded)`` in the compute dtype."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            return params["embed"]["tokens"].to(cfg.compute_dtype).T
        return params["lm_head"].to(cfg.compute_dtype)

    def loss(self, params, peft, batch) -> torch.Tensor:
        """Training loss: the mean cross entropy of ``batch["labels"]``
        (-100 ignored) through the chunked LM head
        (``common.fused_cross_entropy``), which never holds the whole
        ``(B, S, V)`` logits, plus ``router_aux_weight`` times the MoE aux
        loss.  Differentiable in whatever leaves of ``params`` and
        ``peft`` require grad."""
        labels = torch.as_tensor(batch["labels"], dtype=torch.long,
                                 device=self.device)
        x, aux = self._hidden(params, batch, peft)
        loss = fused_cross_entropy(x, self.head_weight(params), labels,
                                   self.cfg.vocab_size)
        if self.cfg.is_moe:
            loss = loss + self.cfg.router_aux_weight * aux
        return loss

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   tp=None) -> Dict[str, torch.Tensor]:
        """The dense decode cache, on ``device`` (default: the model's;
        ``"meta"`` gives its shapes and dtypes without memory); under
        ``tp`` this rank's KV heads."""
        cfg = self.cfg
        dt = dtype or cfg.param_dtype
        dev = self.device if device is None else device
        shape = (cfg.n_layers, batch, max_len, self._heads(tp or ONE)[1],
                 cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    def cache_spec(self) -> Dict[str, CacheLeafSpec]:
        """Slot layout of the ``init_cache`` leaves; the KV leaves have a
        token axis, so a paged cache may pool them."""
        cfg = self.cfg
        kv = PagedCacheLeafSpec(slot_axis=1, page_axis=2,
                                kv_quant=cfg.kv_quant,
                                quant_block=cfg.quant_block_size)
        return {"k": kv, "v": kv, "len": CacheLeafSpec(slot_axis=0)}

    def insert_cache(self, cache, slot_ids, prefill_cache, lengths=None,
                     block_tables=None):
        """Scatter a prefill wave's KV prefixes into the given slots (in
        place); rows past each request's length hold pad-token garbage
        that decode masks and overwrites in order.  With ``block_tables``
        the KV prefixes scatter into the paged pools (pad blocks to the
        null block)."""
        return insert_cache_slots(self.cache_spec(), cache, slot_ids,
                                  prefill_cache, lengths, block_tables)

    @torch.no_grad()
    def prefill(self, params, peft, batch, lengths=None, adapter_ids=None,
                tp=None):
        """Batched prefill of right-padded rows: returns the logits of each
        row's last real position and the wave's cache.  Causality makes the
        right padding exact.  ``adapter_ids`` ``(B,)`` name each row's
        tenant when ``peft`` is an adapter bank (0 = the base model).  A
        serving wave (``lengths`` given) never drops an MoE token; without
        ``lengths`` the training dispatch is kept, as the JAX package's
        bulk prefill.  ``tp``: this rank's shards (the module docstring);
        the wave's cache holds its KV heads."""
        cfg = self.cfg
        tp = tp or ONE
        x = self._embed(params, batch, tp)
        b, s, _ = x.shape
        rope = make_rope(torch.arange(s, device=x.device)[None, :],
                         cfg.head_dim, cfg.rope_theta)
        shape = (cfg.n_layers, b, s, self._heads(tp)[1], cfg.head_dim)
        k_all = torch.empty(shape, dtype=x.dtype, device=x.device)
        v_all = torch.empty(shape, dtype=x.dtype, device=x.device)
        no_drop = lengths is not None
        for i, lp, la in self._layers(params, peft, adapter_ids):
            x, _, (k, v) = self._layer(lp, la, x, rope=rope,
                                       no_drop=no_drop, tp=tp)
            k_all[i] = k
            v_all[i] = v
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if lengths is None:
            lens = torch.full((b,), s, dtype=torch.int32, device=x.device)
        else:
            lens = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
        x = x[torch.arange(b, device=x.device), lens.long() - 1][:, None]
        logits = self._unembed(params, x, tp)
        return logits, {"k": k_all, "v": v_all, "len": lens}

    @torch.no_grad()
    def decode_step(self, params, peft, cache, batch, block_tables=None,
                    adapter_ids=None, mesh=None, tp=None):
        """One decode step: writes each slot's new K/V at ``len`` in place
        and attends over the first ``len + 1`` entries.  With
        ``block_tables (B, max_blocks)`` the KV leaves are paged pools
        (codes and ``*_qscale`` scales when the cache holds them);
        ``adapter_ids`` ``(B,)`` select each slot's tenant of a bank.
        ``batch`` holds ``tokens (B, 1)``, or for an audio model the new
        frame embedding ``embeds (B, 1, d)``.  ``mesh`` (a data-sharded
        paged engine): the batch, cache and tables are one data rank's
        slots and arena, and the paged decode runs per arena.  ``tp``:
        this rank's shards and KV heads.  Returns
        ``(logits, cache)`` with ``cache["len"]`` advanced by one in place
        (every leaf keeps its storage, so a captured CUDA graph of the step
        reads and writes the same cache at every replay)."""
        cfg = self.cfg
        tp = tp or ONE
        # a vision model decodes text tokens
        x = (self._input(batch, "embeds") if cfg.frontend == "audio_tokens"
             else self._table(params, batch, tp)).to(cfg.compute_dtype)
        new_len = cache["len"]
        new_len += 1
        rope = make_rope((new_len - 1)[:, None], cfg.head_dim, cfg.rope_theta)
        keys = (("k", "k_qscale", "v", "v_qscale") if "k_qscale" in cache
                else ("k", "v"))
        tail = (new_len,) if block_tables is None else (new_len,
                                                        block_tables)
        for i, lp, la in self._layers(params, peft, adapter_ids):
            x, _, _ = self._layer(
                lp, la, x, rope=rope,
                cache=tuple(cache[key][i] for key in keys) + tail,
                mesh=mesh, tp=tp,
            )
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._unembed(params, x, tp)
        return _mask_vocab_pad(logits, cfg.vocab_size), dict(cache)

    @torch.no_grad()
    def prefill_chunk(self, params, peft, batch, cache, pos, n_valid,
                      adapter_ids=None, tp=None):
        """One fixed-size chunk of a chunked prefill.

        ``batch["tokens"]`` ``(B, C)`` is the chunk, right-padded on the
        last (maybe partial) chunk; ``cache`` a dense staging cache
        (``init_cache(B, s_stage)``) holding the ``pos`` tokens staged so
        far; ``pos`` and ``n_valid`` (tokens staged so far, real tokens in
        this chunk) are ints or tensors on the model's device, and the step
        never reads them back to the host.  The chunk's K/V are written in
        place at ``[pos, pos + C)`` (the start clamped so that the slab
        fits, as ``dynamic_update_slice`` does) and its queries attend over
        the whole staging buffer, causally (``chunk_attention``): the exact
        continuation of a full prefill.  Returns ``(logits, cache)``:
        ``logits (B, 1, V)`` at the chunk's last real position, and the
        staging cache with ``len = pos + n_valid``.  The finished staging
        cache lands in the serving cache through the same
        ``insert_cache`` scatter as a wave.  ``tp``: this rank's shards
        (the staging cache holds its KV heads)."""
        cfg = self.cfg
        tp = tp or ONE
        if cfg.frontend == "audio_tokens":
            raise ValueError(
                f"{cfg.name}: an audio_tokens model has no token table, so "
                f"it has no chunked prefill of tokens")
        # tokens alone, as the JAX package's chunk step (a vision model
        # chunks its text)
        x = self._table(params, batch, tp).to(cfg.compute_dtype)  # (B, C, d)
        b, c, _ = x.shape
        dev = x.device
        s_stage = cache["k"].shape[2]
        pos = torch.as_tensor(pos, dtype=torch.long, device=dev)
        n_valid = torch.as_tensor(n_valid, dtype=torch.long, device=dev)
        offs = torch.arange(c, device=dev)
        q_pos = pos + offs
        rows = torch.clamp(pos, 0, s_stage - c) + offs
        rope = make_rope(q_pos[None, :], cfg.head_dim, cfg.rope_theta)
        for i, lp, la in self._layers(params, peft, adapter_ids):
            x, _, _ = self._layer(
                lp, la, x, rope=rope,
                chunk=(cache["k"][i], cache["v"][i], rows, q_pos), tp=tp,
            )
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        x = x[torch.arange(b, device=dev), n_valid - 1][:, None]  # (B, 1, d)
        logits = self._unembed(params, x, tp)
        new_len = (pos + n_valid).to(torch.int32).expand(b).clone()
        return (_mask_vocab_pad(logits, cfg.vocab_size),
                dict(cache, len=new_len))


def _mask_vocab_pad(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mask padded vocab columns so they never win softmax/argmax."""
    vpad = logits.shape[-1]
    if vpad == vocab:
        return logits
    col = torch.arange(vpad, device=logits.device)
    return torch.where(col < vocab, logits,
                       torch.finfo(logits.dtype).min)
