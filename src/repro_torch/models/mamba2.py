"""Mamba-2 (SSD: state-space duality), attention-free (port of
``repro/models/mamba2.py``).

Block layout::

    x -> RMSNorm -> {z_proj, x_proj, bc_proj, dt_proj}
      -> causal conv1d (kernel conv_kernel) over [x; B; C]
      -> SSD(x * dt, A * dt, B, C) + D * x
      -> gated RMSNorm(y, silu(z)) -> out_proj -> + residual

A sequence (training, prefill) runs the chunked dual form (Dao & Gu 2024,
arXiv:2405.21060, ``ssd_minimal_discrete``): within a chunk an
attention-like product under the decay kernel, across chunks the state
recurrence by ``common.linear_scan`` (the recursion of
``jax.lax.associative_scan``), in plain PyTorch as the JAX package's is
plain JAX.  Decode keeps an O(1) state a slot per layer (the fp32 SSM
state ``(H, N, P)`` and the conv's last ``conv_kernel - 1`` inputs) and
steps the recurrence; it writes both in place, so a decode tick captures
as one CUDA graph.  The cache has no token axis: ``max_len`` does not
size it and a paged view of it is the dense cache.  There is no
``prefill_chunk``: the serving engine admits Mamba2 by waves.

QuanTA (and any adapter) attaches to ``x_proj`` / ``z_proj`` (d -> 2d)
and ``out_proj`` (2d -> d) through ``peft_linear``, the kernels under
``peft_backend="pallas"``; ``bc_proj`` and ``dt_proj`` are raw products
that stay dense under a quantized base, as in the JAX package.  The
casts are the JAX package's: fp32 ``dt``, decays and SSM state, the decay
kernel times the scores cast to the activation dtype, ``x * dt`` in the
activation dtype in the chunked form but fp32 in the recurrent step, the
state entering each chunk cast to the activation dtype.
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
from repro_torch.kernels.dispatch import default_device, seeded_generator
from repro_torch.models.common import (
    CacheLeafSpec,
    ModelConfig,
    dense_init,
    embed_init,
    fused_cross_entropy,
    gather_conv_tail,
    insert_cache_slots,
    linear_scan,
    rms_norm,
)
from repro_torch.models.transformer import _mask_vocab_pad, padded_vocab

__all__ = ["Mamba2", "ssd_chunk"]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: ``out[..., i, j] = sum_{j < k <= i} x[..., k]``
    (lower triangular), -inf above the diagonal."""
    t = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    ii = torch.arange(t, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunk(s: int, chunk: int) -> int:
    """The chunk length of a sequence of ``s`` positions: the largest
    divisor of ``s`` not above ``chunk`` (5008 = 2^4 * 313 at chunk 256:
    16)."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


class Mamba2(nn.Module):
    """The SSM model whose methods take the params dict (the JAX
    package's layout, so weights carry over by a copy).

    Runs on ``device`` (default: the card; raises when there is none).
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"Mamba2 is the ssm family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = default_device(device)
        self.d_inner = cfg.ssm_expand * cfg.d_model
        self.n_ssm_heads = self.d_inner // cfg.ssm_head_dim
        self.n_groups = 1
        self.conv_dim = self.d_inner + 2 * self.n_groups * cfg.ssm_state

    def _linear(self, x, w, adapter=None, bias=None):
        return peft_linear(x, w, adapter, bias, backend=self.cfg.peft_backend)

    # ------------------------------------------------------------------ init
    def init(self, seed) -> Dict[str, Any]:
        """Random weights from ``seed`` (an int or a ``torch.Generator`` on
        the model's device), drawn in fp32 layer by layer and stored in
        ``cfg.param_dtype``: the JAX package's leaves and shapes, norms and
        the skip ``D`` at one, conv biases at zero, ``dt_bias`` at
        softplus^-1 of steps from 1e-3 to 0.1, ``a_log`` at log of 1..16."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.param_dtype
        gen = seeded_generator(seed, dev)
        d, di, hs, h = cfg.d_model, self.d_inner, cfg.ssm_state, \
            self.n_ssm_heads
        n, k = cfg.n_layers, cfg.conv_kernel

        def layer():
            conv = torch.randn((k, self.conv_dim), generator=gen, device=dev)
            return {
                "z_proj": dense_init(gen, d, di, dt, dev),
                "x_proj": dense_init(gen, d, di, dt, dev),
                "bc_proj": dense_init(gen, d, 2 * self.n_groups * hs, dt,
                                      dev),
                "dt_proj": dense_init(gen, d, h, dt, dev),
                "conv_w": (conv / math.sqrt(k)).to(dt),
                "out_proj": dense_init(gen, di, d, dt, dev),
            }

        first = layer()
        layers = {key: torch.empty((n,) + t.shape, dtype=t.dtype, device=dev)
                  for key, t in first.items()}
        for i in range(n):
            for key, t in (first if i == 0 else layer()).items():
                layers[key][i] = t
        dt_bias = torch.log(torch.expm1(torch.linspace(1e-3, 0.1, h,
                                                       device=dev)))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
        layers.update(
            dt_bias=dt_bias.expand(n, h).to(dt).contiguous(),
            conv_b=torch.zeros((n, self.conv_dim), dtype=dt, device=dev),
            a_log=a_log.expand(n, h).to(dt).contiguous(),
            d_skip=torch.ones((n, h), dtype=dt, device=dev),
            gate_norm=torch.ones((n, di), dtype=dt, device=dev),
            ln=torch.ones((n, d), dtype=dt, device=dev),
        )
        vpad = padded_vocab(cfg.vocab_size)
        return {
            "embed": {"tokens": embed_init(gen, vpad, d, dt, dev)},
            "layers": layers,
            "final_norm": torch.ones((d,), dtype=dt, device=dev),
            "lm_head": dense_init(gen, d, vpad, dt, dev),
        }

    # ------------------------------------------------------------ sub-blocks
    def _embed(self, params, batch) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], dtype=torch.long,
                                 device=self.device)
        return params["embed"]["tokens"][tokens].to(self.cfg.compute_dtype)

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        return x @ params["lm_head"].to(self.cfg.compute_dtype)

    def _project(self, lp, la, xn):
        z = self._linear(xn, lp["z_proj"], get_adapter(la, "z_proj"))
        xs = self._linear(xn, lp["x_proj"], get_adapter(la, "x_proj"))
        bc = xn @ lp["bc_proj"]
        dt_raw = xn @ lp["dt_proj"] + lp["dt_bias"]
        return z, xs, bc, dt_raw

    def _conv(self, lp, xbc):
        """The causal depthwise conv over a sequence, taps in order."""
        k, s = self.cfg.conv_kernel, xbc.shape[1]
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        out = sum(pad[:, i:i + s, :] * lp["conv_w"][i][None, None, :]
                  for i in range(k))
        return F.silu(out + lp["conv_b"][None, None, :])

    # ------------------------------------------------------------ SSD (dual)
    def _ssd_chunked(self, x, dt, a, b_mat, c_mat, return_final=False):
        """The chunked SSD.  ``x (B, S, H, P)``, ``dt (B, S, H)`` fp32,
        ``a (H,)`` negative, ``b``/``c (B, S, G, N)``.  Returns ``y (B, S,
        H, P)``, or ``(y, final_state)`` with the fp32 ``(B, H, N, P)``
        state after the last position when ``return_final`` (the prefill
        to decode hand-off)."""
        bsz, s, h, hd = x.shape
        q = ssd_chunk(s, self.cfg.ssm_chunk)
        nc = s // q
        g, hs = self.n_groups, self.cfg.ssm_state
        hg = h // g                                     # heads a group

        da = (dt * a[None, None, :]).float()            # (B, S, H) <= 0
        xdt = x * dt[..., None].to(x.dtype)
        xc = xdt.reshape(bsz, nc, q, h, hd)
        dac = da.reshape(bsz, nc, q, h)
        bc = b_mat.reshape(bsz, nc, q, g, hs)
        cc = c_mat.reshape(bsz, nc, q, g, hs)

        # 1. within a chunk: attention-like under the decay kernel
        l_mat = torch.exp(_segsum(dac.movedim(-1, -2)))   # (B, nc, H, q, q)
        scores = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)
        scores = torch.repeat_interleave(scores, hg, dim=2)
        y_diag = torch.einsum("bchqk,bckhd->bcqhd",
                              (scores * l_mat).to(x.dtype), xc)

        # 2. each chunk's final state
        dac_cum = torch.cumsum(dac, dim=2)                # (B, nc, q, H)
        decay_to_end = torch.exp(dac_cum[:, :, -1:, :] - dac_cum)
        states = torch.einsum(
            "bcqhn,bcqhd->bchnd",
            (torch.repeat_interleave(bc, hg, dim=3)
             * decay_to_end[..., None]).to(x.dtype),
            xc)                                           # (B, nc, H, N, P)

        # 3. across chunks: h_c = exp(sum dA_c) * h_{c-1} + states_c
        chunk_decay = torch.exp(dac_cum[:, :, -1, :])     # (B, nc, H)
        hidden = linear_scan(chunk_decay[..., None, None].float(),
                             states.float())
        # the state entering chunk c is hidden[c - 1]
        h_prev = torch.cat([torch.zeros_like(hidden[:, :1]), hidden[:, :-1]],
                           dim=1).to(x.dtype)

        # 4. the output from the entering state: decay-in * C @ h_prev
        decay_in = torch.exp(dac_cum)                     # (B, nc, q, H)
        cx = torch.repeat_interleave(cc, hg, dim=3)       # (B, nc, q, H, N)
        y_off = torch.einsum("bcqhn,bchnd->bcqhd",
                             (cx * decay_in[..., None]).to(x.dtype), h_prev)
        y = (y_diag + y_off).reshape(bsz, s, h, hd)
        if return_final:
            return y, hidden[:, -1]
        return y

    # ------------------------------------------------------------ layer body
    def _layer(self, lp, la, x, cache=None, prefill_lengths=None):
        """One Mamba2 block.  ``cache = (ssm (B, H, N, P) fp32, conv (B,
        K-1, conv_dim))`` steps one token; ``None`` runs the sequence by
        the chunked dual form.  With ``prefill_lengths`` (a right-padded
        wave) ``dt`` is zeroed at pad positions, so their state update is
        the identity and the final state is each row's at its last real
        token, and the block also returns each row's decode-ready (ssm,
        conv) state.  Returns ``(x + out, new_cache)``."""
        cfg = self.cfg
        bsz, s, _ = x.shape
        h, hd, hs = self.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        xn = rms_norm(x, lp["ln"], cfg.norm_eps)
        z, xs, bc, dt_raw = self._project(lp, la, xn)
        xbc = torch.cat([xs, bc], dim=-1)                 # (B, S, conv_dim)

        new_cache = None
        if cache is None:
            xbc_raw = xbc          # pre-conv: what decode's window keeps
            xbc = self._conv(lp, xbc)
        else:
            ssm_state, conv_state = cache
            window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
            conv_out = torch.einsum("bkc,kc->bc", window, lp["conv_w"])
            xbc = F.silu(conv_out + lp["conv_b"])[:, None, :]
            new_conv = window[:, 1:, :]

        g = self.n_groups
        xs2 = xbc[..., :self.d_inner].reshape(bsz, -1, h, hd)
        b_mat = xbc[..., self.d_inner:self.d_inner + g * hs].reshape(
            bsz, -1, g, hs)
        c_mat = xbc[..., self.d_inner + g * hs:].reshape(bsz, -1, g, hs)
        # softplus as jax.nn.softplus (F.softplus switches to x above 20)
        dtf = dt_raw.float()
        dt = torch.logaddexp(dtf, torch.zeros_like(dtf))    # (B, S, H)
        a = -torch.exp(lp["a_log"].float())                # (H,)

        if cache is None and prefill_lengths is not None:
            lens = prefill_lengths.to(x.device)
            pad_mask = (torch.arange(s, device=x.device)[None, :]
                        < lens[:, None])                   # (B, S)
            dt = dt * pad_mask[..., None]
            y, ssm_final = self._ssd_chunked(xs2, dt, a, b_mat, c_mat,
                                             return_final=True)
            new_cache = (ssm_final, gather_conv_tail(xbc_raw, lens,
                                                     cfg.conv_kernel - 1))
        elif cache is None:
            y = self._ssd_chunked(xs2, dt, a, b_mat, c_mat)
        else:
            # h' = exp(dt a) h + (dt x) outer B;  y = C . h'
            da = torch.exp(dt[:, 0, :] * a[None, :])       # (B, H)
            xdt = xs2[:, 0] * dt[:, 0, :, None]           # fp32 (B, H, P)
            bg = torch.repeat_interleave(b_mat[:, 0], h // g, dim=1)
            cg = torch.repeat_interleave(c_mat[:, 0], h // g, dim=1)
            new_state = (ssm_state * da[..., None, None]
                         + torch.einsum("bhn,bhd->bhnd",
                                        bg.to(xdt.dtype), xdt
                                        ).to(ssm_state.dtype))
            y = torch.einsum("bhn,bhnd->bhd", cg, new_state.to(cg.dtype))
            y = y[:, None, :, :]                          # (B, 1, H, P)
            new_cache = (new_state, new_conv)

        y = y + xs2 * lp["d_skip"].to(y.dtype)[None, None, :, None]
        y = y.reshape(bsz, -1, self.d_inner)
        y = rms_norm(y * F.silu(z), lp["gate_norm"], cfg.norm_eps)
        out = self._linear(y, lp["out_proj"], get_adapter(la, "out_proj"))
        return x + out, new_cache

    def _layers(self, params, peft, adapter_ids=None):
        adapters = adapter_subtree(peft, "layers", adapter_ids)
        for i in range(self.cfg.n_layers):
            yield i, layer_tree(params["layers"], i), layer_tree(adapters, i)

    # --------------------------------------------------------------- forward
    def _hidden(self, params, batch, peft=None):
        """The final-norm hidden states ``(B, S, d)``.  Under ``cfg.remat``
        (with grad on) each layer runs under ``torch.utils.checkpoint``."""
        cfg = self.cfg
        x = self._embed(params, batch)
        remat = cfg.remat and torch.is_grad_enabled()
        for _, lp, la in self._layers(params, peft):
            def body(h, lp=lp, la=la):
                return self._layer(lp, la, h)[0]

            x = (torch.utils.checkpoint.checkpoint(body, x,
                                                   use_reentrant=False)
                 if remat else body(x))
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
        """The decode cache, on ``device`` (default: the model's;
        ``"meta"`` gives its shapes and dtypes without memory): per layer
        and slot the fp32 SSM state ``(H, N, P)`` and the conv window of
        ``conv_kernel - 1`` inputs, whatever ``max_len``."""
        cfg = self.cfg
        dt = dtype or cfg.param_dtype
        dev = self.device if device is None else device
        h, hd, hs = self.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        return {
            "ssm": torch.zeros((cfg.n_layers, batch, h, hs, hd),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                                 self.conv_dim), dtype=dt, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    def cache_spec(self) -> Dict[str, CacheLeafSpec]:
        """Slot layout of the ``init_cache`` leaves: O(1) states with no
        token axis, so nothing is paged."""
        return {
            "ssm": CacheLeafSpec(slot_axis=1),
            "conv": CacheLeafSpec(slot_axis=1),
            "len": CacheLeafSpec(slot_axis=0),
        }

    def insert_cache(self, cache, slot_ids, prefill_cache, lengths=None,
                     block_tables=None):
        """Scatter a prefill wave's final states into the given slots, in
        place.  ``block_tables`` is taken for the engine's uniformity and
        unused: there is nothing to page."""
        del block_tables
        return insert_cache_slots(self.cache_spec(), cache, slot_ids,
                                  prefill_cache, lengths)

    @torch.no_grad()
    def prefill(self, params, peft, batch, lengths=None, adapter_ids=None):
        """Batched prefill of right-padded rows by the chunked dual form:
        the logits of each row's last real position and a decode-ready
        cache (each layer's final SSM state and conv window).
        ``adapter_ids`` ``(B,)`` name each row's tenant when ``peft`` is
        an adapter bank."""
        cfg = self.cfg
        x = self._embed(params, batch)
        b, s, _ = x.shape
        dev = x.device
        lens = (torch.full((b,), s, dtype=torch.int32, device=dev)
                if lengths is None
                else torch.as_tensor(lengths, dtype=torch.int32, device=dev))
        cache = self.init_cache(b, s, device=dev)
        cache["len"] = lens
        for i, lp, la in self._layers(params, peft, adapter_ids):
            x, (ssm, conv) = self._layer(lp, la, x, prefill_lengths=lens)
            cache["ssm"][i] = ssm
            cache["conv"][i] = conv.to(cfg.param_dtype)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        x = x[torch.arange(b, device=dev), lens.long() - 1][:, None]
        return self._unembed(params, x), cache

    @torch.no_grad()
    def decode_step(self, params, peft, cache, batch, block_tables=None,
                    adapter_ids=None, mesh=None):
        """One decode step: every layer's SSM state and conv window take
        the new token in place (``block_tables`` and ``mesh`` unused:
        nothing is paged).  Returns ``(logits, cache)`` with ``cache["len"]`` advanced
        by one in place: every leaf keeps its storage, so a captured CUDA
        graph of the step reads and writes the same cache at every
        replay."""
        del block_tables, mesh
        cfg = self.cfg
        x = self._embed(params, batch)                           # (B,1,d)
        cache["len"] += 1
        for i, lp, la in self._layers(params, peft, adapter_ids):
            ssm, conv = cache["ssm"][i], cache["conv"][i]
            x, (new_ssm, new_conv) = self._layer(lp, la, x,
                                                 cache=(ssm, conv))
            ssm.copy_(new_ssm)
            conv.copy_(new_conv)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._unembed(params, x)
        return _mask_vocab_pad(logits, cfg.vocab_size), dict(cache)
