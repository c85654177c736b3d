"""RecurrentGemma / Griffin hybrid (port of ``repro/models/griffin.py``):
RG-LRU recurrent blocks and local attention, one attention layer in
``attn_period``.

``n_layers // attn_period`` macro blocks of (rec, mlp, rec, mlp, local
attention, mlp), layer-stacked under ``params["blocks"]`` as the JAX
package scans them, then a tail of ``n_layers % attn_period`` unstacked
(rec, mlp) pairs under ``params["tail"]`` (recurrentgemma-2b: 8 macro
blocks and a 2-layer tail).  Every temporal-mixing block is followed by a
GeGLU MLP; ``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s
default.

RG-LRU (arXiv:2402.19427), its gates and recurrence in fp32::

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    a_t = exp(-c * softplus(Lambda) * r_t),       c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A sequence runs the recurrence as ``common.linear_scan``, the recursion
of ``jax.lax.associative_scan`` (differentiable, static shapes); decode
keeps an O(1) state per recurrent block (the LRU state and the conv's
last ``conv_kernel - 1`` inputs) and the local attention's K/V in a
``local_window``-row ring buffer: row ``p % window`` holds position
``p``, with ``pos`` the position each row holds (-1: none).  Prefill runs
the flash forward (kernel 3 under ``attn_backend="pallas"``) with the
window; decode attends over the ring in plain PyTorch, as the JAX package
does (a dense ring, a paged ring of rows, or a paged ring of NF4/int8
codes).  Serving updates the cache in place, so a decode tick captures as
one CUDA graph: every index it takes stays on the device.  There is no
``prefill_chunk``: the serving engine admits Griffin by waves.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.peft import (
    adapter_subtree, get_adapter, layer_tree, peft_linear,
)
from repro_torch.core.quantize import (
    fake_quantize_kv, kv_dequant_values, quantize_kv,
)
from repro_torch.kernels.dispatch import (
    MASK_VALUE, default_device, masked_softmax, seeded_generator,
)
from repro_torch.models.attention import blockwise_causal_attention
from repro_torch.models.common import (
    CacheLeafSpec,
    ModelConfig,
    PagedCacheLeafSpec,
    apply_rope,
    dense_init,
    embed_init,
    fused_cross_entropy,
    gather_conv_tail,
    insert_cache_slots,
    linear_scan,
    make_rope,
    rms_norm,
)
from repro_torch.models.transformer import _mask_vocab_pad, padded_vocab

__all__ = ["Griffin"]

_LRU_C = 8.0


class Griffin(nn.Module):
    """The hybrid model whose methods take the params dict (the JAX
    package's layout, so weights carry over by a copy).

    Runs on ``device`` (default: the card; raises when there is none).
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"Griffin is the hybrid family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = default_device(device)
        self.d_rnn = cfg.lru_width or cfg.d_model
        self.n_macro = cfg.n_layers // cfg.attn_period
        self.n_tail = cfg.n_layers - self.n_macro * cfg.attn_period

    def _linear(self, x, w, adapter=None, bias=None):
        return peft_linear(x, w, adapter, bias, backend=self.cfg.peft_backend)

    # ------------------------------------------------------------------ init
    def init(self, seed) -> Dict[str, Any]:
        """Random weights from ``seed`` (an int or a ``torch.Generator`` on
        the model's device), drawn in fp32 block by block and stored in
        ``cfg.param_dtype``; norms at one, conv biases at zero, Lambda at
        softplus^-1 of decays from 0.9 to 0.999."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.param_dtype
        gen = seeded_generator(seed, dev)
        d, dr, ff, k = cfg.d_model, self.d_rnn, cfg.d_ff, cfg.conv_kernel
        decay = torch.exp(torch.linspace(math.log(0.9), math.log(0.999), dr,
                                         device=dev))
        lam = torch.log(torch.expm1(decay)).to(dt)

        def rec():
            conv = torch.randn((k, dr), generator=gen, device=dev)
            return {
                "ln": torch.ones((d,), dtype=dt, device=dev),
                "gate_proj": dense_init(gen, d, dr, dt, dev),
                "rec_proj": dense_init(gen, d, dr, dt, dev),
                "conv_w": (conv / math.sqrt(k)).to(dt),
                "conv_b": torch.zeros((dr,), dtype=dt, device=dev),
                "w_a": dense_init(gen, dr, dr, dt, dev),
                "w_x": dense_init(gen, dr, dr, dt, dev),
                "lambda": lam.clone(),
                "out_proj": dense_init(gen, dr, d, dt, dev),
            }

        def mlp():
            return {
                "ln": torch.ones((d,), dtype=dt, device=dev),
                "gate_proj": dense_init(gen, d, ff, dt, dev),
                "up_proj": dense_init(gen, d, ff, dt, dev),
                "down_proj": dense_init(gen, ff, d, dt, dev),
            }

        def attn():
            return {
                "ln": torch.ones((d,), dtype=dt, device=dev),
                "q_proj": dense_init(gen, d, cfg.attn_dim, dt, dev),
                "k_proj": dense_init(gen, d, cfg.kv_dim, dt, dev),
                "v_proj": dense_init(gen, d, cfg.kv_dim, dt, dev),
                "o_proj": dense_init(gen, cfg.attn_dim, d, dt, dev),
            }

        def stack(make):
            # one block at a time, stacked leaf by leaf into its slot
            first = make()
            out = {n: torch.empty((self.n_macro,) + t.shape, dtype=t.dtype,
                                  device=dev) for n, t in first.items()}
            for i in range(self.n_macro):
                blk = first if i == 0 else make()
                for n, t in blk.items():
                    out[n][i] = t
            return out

        vpad = padded_vocab(cfg.vocab_size)
        params: Dict[str, Any] = {
            "embed": {"tokens": embed_init(gen, vpad, d, dt, dev)},
            "blocks": {"rec1": stack(rec), "mlp1": stack(mlp),
                       "rec2": stack(rec), "mlp2": stack(mlp),
                       "attn": stack(attn), "mlp3": stack(mlp)},
            "final_norm": torch.ones((d,), dtype=dt, device=dev),
            "lm_head": dense_init(gen, d, vpad, dt, dev),
        }
        tail: Dict[str, Any] = {}
        for i in range(self.n_tail):
            tail[f"rec{i + 1}"] = rec()
            tail[f"mlp{i + 1}"] = mlp()
        if tail:
            params["tail"] = tail
        return params

    # ------------------------------------------------------------ sub-blocks
    def _embed(self, params, batch) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], dtype=torch.long,
                                 device=self.device)
        return params["embed"]["tokens"][tokens].to(self.cfg.compute_dtype)

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        return x @ params["lm_head"].to(self.cfg.compute_dtype)

    def _mlp(self, lp, la, x):
        h = rms_norm(x, lp["ln"], self.cfg.norm_eps)
        g = self._linear(h, lp["gate_proj"], get_adapter(la, "gate_proj"))
        u = self._linear(h, lp["up_proj"], get_adapter(la, "up_proj"))
        return x + self._linear(F.gelu(g, approximate="tanh") * u,
                                lp["down_proj"], get_adapter(la, "down_proj"))

    def _rec_block(self, lp, la, x, state=None, prefill_lengths=None):
        """Griffin recurrent block.  ``state = (lru (B, dr), conv (B, K-1,
        dr))`` steps one token; ``None`` runs the sequence by
        ``common.linear_scan``.  With ``prefill_lengths`` (a right-padded
        wave) pad positions take the identity update (a = 1, input 0), and
        the block also returns each row's decode-ready (lru, conv) state.
        Returns ``(x + out, new_state)``."""
        cfg = self.cfg
        s = x.shape[1]
        xn = rms_norm(x, lp["ln"], cfg.norm_eps)
        gate = F.gelu(self._linear(xn, lp["gate_proj"],
                                   get_adapter(la, "gate_proj")),
                      approximate="tanh")
        u = self._linear(xn, lp["rec_proj"], get_adapter(la, "rec_proj"))

        k = cfg.conv_kernel
        conv_w, conv_b = lp["conv_w"], lp["conv_b"]
        if state is None:
            u_raw = u                  # pre-conv: what decode's window keeps
            pad = F.pad(u, (0, 0, k - 1, 0))
            u = sum(pad[:, i:i + s, :] * conv_w[i][None, None, :]
                    for i in range(k)) + conv_b[None, None, :]
        else:
            lru_state, conv_state = state
            window = torch.cat([conv_state.to(u.dtype), u], dim=1)  # (B,K,dr)
            u = (torch.einsum("bkc,kc->bc", window, conv_w)
                 + conv_b)[:, None, :]
            new_conv = window[:, 1:, :]

        # RG-LRU gates, fp32 recurrence
        r = torch.sigmoid((u @ lp["w_a"]).float())
        i_gate = torch.sigmoid((u @ lp["w_x"]).float())
        lam = lp["lambda"].float()
        log_a = -_LRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
        pad_mask = None
        if state is None and prefill_lengths is not None:
            lens = prefill_lengths.to(x.device)
            pad_mask = (torch.arange(s, device=x.device)[None, :]
                        < lens[:, None]).float()[..., None]    # (B, S, 1)
            log_a = log_a * pad_mask
        a = torch.exp(log_a)
        gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
            i_gate * u.float())
        if pad_mask is not None:
            gated_in = gated_in * pad_mask

        if state is None:
            h = linear_scan(a, gated_in)                       # (B, S, dr)
            new_state = None
            if prefill_lengths is not None:
                new_state = (h[:, -1], gather_conv_tail(u_raw, lens, k - 1))
        else:
            h = a[:, 0] * lru_state + gated_in[:, 0]
            new_state = (h, new_conv)
            h = h[:, None, :]

        y = h.to(x.dtype) * gate
        out = self._linear(y, lp["out_proj"], get_adapter(la, "out_proj"))
        return x + out, new_state

    def _qkv(self, lp, la, x, rope):
        cfg = self.cfg
        b, s, _ = x.shape
        xn = rms_norm(x, lp["ln"], cfg.norm_eps)
        q = self._linear(xn, lp["q_proj"], get_adapter(la, "q_proj"))
        k = self._linear(xn, lp["k_proj"], get_adapter(la, "k_proj"))
        v = self._linear(xn, lp["v_proj"], get_adapter(la, "v_proj"))
        q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        cos, sin = rope
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _attn_block(self, lp, la, x, rope, prefill_lengths=None):
        """Local attention over a sequence (the flash forward under
        ``attn_backend="pallas"``).  With ``prefill_lengths`` it also
        returns the decode ring: row ``j`` holds the newest position ``p <
        len`` with ``p % window == j`` (what sequential decode writes
        would have left), zeros and position -1 where there is none.
        Returns ``(x + out, (k_ring, v_ring, pos_ring) or None)``."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self._qkv(lp, la, x, rope)
        out = blockwise_causal_attention(
            q, k, v, q_block=cfg.q_block, window=cfg.local_window,
            fast_softmax=cfg.fast_softmax, backend=cfg.attn_backend)
        ring = None
        if prefill_lengths is not None:
            w = cfg.local_window
            dev = x.device
            last = (prefill_lengths.to(dev).long() - 1)[:, None]     # (B, 1)
            p = last - torch.remainder(last - torch.arange(w, device=dev), w)
            valid = p >= 0                                           # (B, w)
            pc = torch.clamp(p, 0, s - 1)
            b_idx = torch.arange(b, device=dev)[:, None]
            gone = ~valid[..., None, None]
            ring = (k[b_idx, pc].masked_fill(gone, 0),
                    v[b_idx, pc].masked_fill(gone, 0),
                    p.masked_fill(~valid, -1).to(torch.int32))
        out = out.reshape(b, s, cfg.attn_dim)
        out = self._linear(out, lp["o_proj"], get_adapter(la, "o_proj"))
        return x + out, ring

    def _attn_step(self, lp, la, x, rope, ring, new_len, block_tables):
        """One decode step of local attention: the new token's K/V written
        in place at ring row ``(len - 1) % window`` (of a dense ring, or
        through ``block_tables`` into a paged ring of rows or, with scale
        pools in ``ring``, of NF4/int8 codes quantized on write), then
        attention over the ring in plain PyTorch.  ``ring`` is ``(k, v,
        pos)`` or ``(k, k_scales, v, v_scales, pos)``."""
        cfg = self.cfg
        b = x.shape[0]
        dev = x.device
        w, hd = cfg.local_window, cfg.head_dim
        q, kk, v = self._qkv(lp, la, x, rope)
        b_idx = torch.arange(b, device=dev)
        last = (new_len - 1).long()                                  # (B,)
        r = torch.remainder(last, w)
        row_valid = None
        if block_tables is None:
            k_ring, v_ring, pos_ring = ring
            k_w, v_w = kk[:, 0], v[:, 0]
            if cfg.kv_quant is not None:
                # the dense reference of the quantized pools stores the
                # quantize-dequantize round trip
                k_w = fake_quantize_kv(k_w, cfg.kv_quant,
                                       block_size=cfg.quant_block_size)
                v_w = fake_quantize_kv(v_w, cfg.kv_quant,
                                       block_size=cfg.quant_block_size)
            k_ring[b_idx, r] = k_w.to(k_ring.dtype)
            v_ring[b_idx, r] = v_w.to(v_ring.dtype)
            pos_ring[b_idx, r] = last.to(pos_ring.dtype)
        else:
            bt = block_tables.long()
            pos_pool = ring[-1]
            bs, nb = pos_pool.shape[1], bt.shape[1]
            blk, row = bt[b_idx, r // bs], r % bs
            if len(ring) == 3:
                k_pool, v_pool = ring[0], ring[1]
                k_pool[blk, row] = kk[:, 0].to(k_pool.dtype)
                v_pool[blk, row] = v[:, 0].to(v_pool.dtype)
                k_ring = k_pool[bt].reshape(b, nb * bs, *k_pool.shape[2:])
                v_ring = v_pool[bt].reshape(b, nb * bs, *v_pool.shape[2:])
            else:
                k_pool, ks_pool, v_pool, vs_pool = ring[:4]
                qb = cfg.quant_block_size
                kc, ks = quantize_kv(kk[:, 0], cfg.kv_quant, block_size=qb)
                vc, vs = quantize_kv(v[:, 0], cfg.kv_quant, block_size=qb)
                for pool, val in ((k_pool, kc), (ks_pool, ks),
                                  (v_pool, vc), (vs_pool, vs)):
                    pool[blk, row] = val.to(pool.dtype)

                def dequant(codes, scales):
                    return kv_dequant_values(
                        codes[bt].reshape(b, nb * bs, *codes.shape[2:]),
                        scales[bt].reshape(b, nb * bs, *scales.shape[2:]),
                        fmt=cfg.kv_quant, block_size=qb, d=hd,
                    ).to(cfg.param_dtype)

                k_ring = dequant(k_pool, ks_pool)
                v_ring = dequant(v_pool, vs_pool)
            pos_pool[blk, row] = last.to(pos_pool.dtype)
            pos_ring = pos_pool[bt].reshape(b, nb * bs)
            # the rows a slot has written are [0, min(len, w)): the rest
            # come through table entries that repeat its last block
            row_valid = (torch.arange(nb * bs, device=dev)[None, :]
                         < torch.clamp(new_len, max=w)[:, None])
        q_pos = last[:, None]                                        # (B, 1)
        g = cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(b, 1, cfg.n_kv_heads, g, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                              k_ring.float()) * (1.0 / math.sqrt(hd))
        valid = ((pos_ring >= 0) & (pos_ring <= q_pos)
                 & (q_pos - pos_ring < w))                           # (B, W')
        if row_valid is not None:
            valid = valid & row_valid
        scores = torch.where(valid[:, None, None, None, :], scores,
                             MASK_VALUE)
        probs = masked_softmax(scores, v_ring.dtype, cfg.fast_softmax)
        out = torch.einsum("bkgqs,bskh->bqkgh", probs, v_ring).reshape(
            b, 1, cfg.attn_dim)
        return x + self._linear(out, lp["o_proj"], get_adapter(la, "o_proj"))

    # ------------------------------------------------------------- sequence
    def _macro(self, bp, ba, x, rope):
        """One (rec, mlp, rec, mlp, attn, mlp) macro block over a
        sequence."""
        x, _ = self._rec_block(bp["rec1"], ba.get("rec1", {}), x)
        x = self._mlp(bp["mlp1"], ba.get("mlp1", {}), x)
        x, _ = self._rec_block(bp["rec2"], ba.get("rec2", {}), x)
        x = self._mlp(bp["mlp2"], ba.get("mlp2", {}), x)
        x, _ = self._attn_block(bp["attn"], ba.get("attn", {}), x, rope)
        return self._mlp(bp["mlp3"], ba.get("mlp3", {}), x)

    def _tail(self, params, tail_adapters, x, states=None, lens=None,
              cache=None):
        """The unstacked recurrent tail: over a sequence (``lens``: also
        each row's decode state, into ``cache`` when given) or, with
        ``states``, one decode step whose new states are written into
        those tensors in place."""
        for i in range(self.n_tail):
            rec, mlp = f"rec{i + 1}", f"mlp{i + 1}"
            tp, ta = params["tail"], tail_adapters
            st = None if states is None else states[i]
            x, new = self._rec_block(tp[rec], ta.get(rec, {}), x, state=st,
                                     prefill_lengths=lens)
            if st is not None:
                st[0].copy_(new[0])
                st[1].copy_(new[1])
            elif cache is not None:
                cache[f"tail_lru{i + 1}"] = new[0]
                cache[f"tail_conv{i + 1}"] = new[1].to(self.cfg.param_dtype)
            x = self._mlp(tp[mlp], ta.get(mlp, {}), x)
        return x

    def _hidden(self, params, batch, peft=None):
        """The final-norm hidden states ``(B, S, d)``.  Under ``cfg.remat``
        (with grad on) each macro block runs under
        ``torch.utils.checkpoint``; the tail does not, as in the JAX
        package."""
        cfg = self.cfg
        x = self._embed(params, batch)
        rope = make_rope(torch.arange(x.shape[1], device=x.device)[None, :],
                         cfg.head_dim, cfg.rope_theta)
        remat = cfg.remat and torch.is_grad_enabled()
        blocks = adapter_subtree(peft, "blocks")
        for i in range(self.n_macro):
            bp, ba = layer_tree(params["blocks"], i), layer_tree(blocks, i)

            def body(h, bp=bp, ba=ba):
                return self._macro(bp, ba, h, rope)

            x = (torch.utils.checkpoint.checkpoint(body, x,
                                                   use_reentrant=False)
                 if remat else body(x))
        x = self._tail(params, adapter_subtree(peft, "tail"), x)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    @torch.no_grad()
    def forward(self, params, batch, peft=None, *, last_only: bool = False):
        """Full-sequence forward: ``(logits, 0.0)`` (the aux slot of the
        model protocol)."""
        x = self._hidden(params, batch, peft)
        if last_only:
            x = x[:, -1:]
        return self._unembed(params, x), 0.0

    def head_weight(self, params) -> torch.Tensor:
        """The LM head ``(d, V_padded)`` in the compute dtype."""
        return params["lm_head"].to(self.cfg.compute_dtype)

    def loss(self, params, peft, batch) -> torch.Tensor:
        """Training loss: the mean cross entropy of ``batch["labels"]``
        (-100 ignored) through the chunked LM head; differentiable in
        whatever leaves of ``params`` and ``peft`` require grad."""
        labels = torch.as_tensor(batch["labels"], dtype=torch.long,
                                 device=self.device)
        x = self._hidden(params, batch, peft)
        return fused_cross_entropy(x, self.head_weight(params), labels,
                                   self.cfg.vocab_size)

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None
                   ) -> Dict[str, torch.Tensor]:
        """The dense decode cache, on ``device`` (default: the model's;
        ``"meta"`` gives its shapes and dtypes without memory): per macro
        block the two recurrent blocks' LRU (fp32) and conv states and the
        attention ring (``local_window`` rows, whatever ``max_len``), and
        the tail's states."""
        cfg = self.cfg
        dt = dtype or cfg.param_dtype
        dev = self.device if device is None else device
        dr, w, km, nm = self.d_rnn, cfg.local_window, cfg.conv_kernel - 1, \
            self.n_macro
        ring = (nm, batch, w, cfg.n_kv_heads, cfg.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        cache = {
            "lru1": zeros((nm, batch, dr), torch.float32),
            "conv1": zeros((nm, batch, km, dr), dt),
            "lru2": zeros((nm, batch, dr), torch.float32),
            "conv2": zeros((nm, batch, km, dr), dt),
            "k": zeros(ring, dt),
            "v": zeros(ring, dt),
            "pos": torch.full((nm, batch, w), -1, dtype=torch.int32,
                              device=dev),
            "len": zeros((batch,), torch.int32),
        }
        for i in range(self.n_tail):
            cache[f"tail_lru{i + 1}"] = zeros((batch, dr), torch.float32)
            cache[f"tail_conv{i + 1}"] = zeros((batch, km, dr), dt)
        return cache

    def cache_spec(self) -> Dict[str, CacheLeafSpec]:
        """Slot layout of the ``init_cache`` leaves: the ring leaves
        (``k``, ``v``, ``pos``) have a row axis and are paged as rings
        (a slot holds at most ``ceil(local_window / block_size)`` blocks);
        the O(1) recurrent states stay dense.  ``cfg.kv_quant`` marks the
        float ring leaves for quantized pools; ``pos`` (int32) stays as it
        is."""
        cfg = self.cfg
        kv = PagedCacheLeafSpec(slot_axis=1, page_axis=2, ring=True,
                                kv_quant=cfg.kv_quant,
                                quant_block=cfg.quant_block_size)
        spec = {
            "lru1": CacheLeafSpec(slot_axis=1),
            "conv1": CacheLeafSpec(slot_axis=1),
            "lru2": CacheLeafSpec(slot_axis=1),
            "conv2": CacheLeafSpec(slot_axis=1),
            "k": kv,
            "v": kv,
            "pos": PagedCacheLeafSpec(slot_axis=1, page_axis=2, fill=-1,
                                      ring=True),
            "len": CacheLeafSpec(slot_axis=0),
        }
        for i in range(self.n_tail):
            spec[f"tail_lru{i + 1}"] = CacheLeafSpec(slot_axis=0)
            spec[f"tail_conv{i + 1}"] = CacheLeafSpec(slot_axis=0)
        return spec

    def insert_cache(self, cache, slot_ids, prefill_cache, lengths=None,
                     block_tables=None):
        """Scatter a prefill wave's recurrent states and rings into the
        given slots, in place (``block_tables``: the ring leaves into
        paged pools)."""
        return insert_cache_slots(self.cache_spec(), cache, slot_ids,
                                  prefill_cache, lengths, block_tables)

    @torch.no_grad()
    def prefill(self, params, peft, batch, lengths=None, adapter_ids=None):
        """Batched prefill of right-padded rows: the logits of each row's
        last real position and a decode-ready cache (each recurrent
        block's final LRU and conv states, each attention layer's ring).
        ``adapter_ids`` ``(B,)`` name each row's tenant when ``peft`` is
        an adapter bank."""
        cfg = self.cfg
        x = self._embed(params, batch)
        b, s, _ = x.shape
        dev, dt = x.device, cfg.param_dtype
        lens = (torch.full((b,), s, dtype=torch.int32, device=dev)
                if lengths is None
                else torch.as_tensor(lengths, dtype=torch.int32, device=dev))
        rope = make_rope(torch.arange(s, device=dev)[None, :], cfg.head_dim,
                         cfg.rope_theta)
        cache = self.init_cache(b, s, device=dev)
        cache["len"] = lens
        blocks = adapter_subtree(peft, "blocks", adapter_ids)
        for i in range(self.n_macro):
            bp, ba = layer_tree(params["blocks"], i), layer_tree(blocks, i)
            for j in (1, 2):
                x, (lru, conv) = self._rec_block(
                    bp[f"rec{j}"], ba.get(f"rec{j}", {}), x,
                    prefill_lengths=lens)
                cache[f"lru{j}"][i] = lru
                cache[f"conv{j}"][i] = conv.to(dt)
                x = self._mlp(bp[f"mlp{j}"], ba.get(f"mlp{j}", {}), x)
            x, (k_r, v_r, pos_r) = self._attn_block(
                bp["attn"], ba.get("attn", {}), x, rope, prefill_lengths=lens)
            cache["k"][i] = k_r.to(dt)
            cache["v"][i] = v_r.to(dt)
            cache["pos"][i] = pos_r
            x = self._mlp(bp["mlp3"], ba.get("mlp3", {}), x)
        x = self._tail(params, adapter_subtree(peft, "tail", adapter_ids), x,
                       lens=lens, cache=cache)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        x = x[torch.arange(b, device=dev), lens.long() - 1][:, None]
        return self._unembed(params, x), cache

    @torch.no_grad()
    def decode_step(self, params, peft, cache, batch, block_tables=None,
                    adapter_ids=None, mesh=None):
        """One decode step: each recurrent block's states and each ring
        take the new token in place (a paged ring through
        ``block_tables``; codes and ``*_qscale`` scales when the cache
        holds them).  ``mesh`` (a data-sharded paged engine): the ring
        pools are this data rank's arena, which its global table rows
        reach shifted by the arena's offset.  Returns ``(logits, cache)`` with ``cache["len"]``
        advanced by one in place: every leaf keeps its storage, so a
        captured CUDA graph of the step reads and writes the same cache at
        every replay."""
        cfg = self.cfg
        if mesh is not None and block_tables is not None:
            from repro_torch.launch.mesh import dp_index

            block_tables = block_tables - dp_index(mesh) * cache["k"].shape[1]
        x = self._embed(params, batch)                               # (B,1,d)
        new_len = cache["len"]
        new_len += 1
        rope = make_rope((new_len - 1)[:, None], cfg.head_dim, cfg.rope_theta)
        ring_keys = (("k", "k_qscale", "v", "v_qscale", "pos")
                     if "k_qscale" in cache else ("k", "v", "pos"))
        blocks = adapter_subtree(peft, "blocks", adapter_ids)
        for i in range(self.n_macro):
            bp, ba = layer_tree(params["blocks"], i), layer_tree(blocks, i)
            for j in (1, 2):
                lru, conv = cache[f"lru{j}"][i], cache[f"conv{j}"][i]
                x, (h, new_conv) = self._rec_block(
                    bp[f"rec{j}"], ba.get(f"rec{j}", {}), x,
                    state=(lru, conv))
                lru.copy_(h)
                conv.copy_(new_conv)
                x = self._mlp(bp[f"mlp{j}"], ba.get(f"mlp{j}", {}), x)
            x = self._attn_step(bp["attn"], ba.get("attn", {}), x, rope,
                                tuple(cache[key][i] for key in ring_keys),
                                new_len, block_tables)
            x = self._mlp(bp["mlp3"], ba.get("mlp3", {}), x)
        states = [(cache[f"tail_lru{i + 1}"], cache[f"tail_conv{i + 1}"])
                  for i in range(self.n_tail)]
        x = self._tail(params, adapter_subtree(peft, "tail", adapter_ids), x,
                       states=states)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._unembed(params, x)
        return _mask_vocab_pad(logits, cfg.vocab_size), dict(cache)
