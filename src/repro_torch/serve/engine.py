"""Continuous-batching serving engine with prefill admission, over a dense
or a paged cache (port of ``repro/serve/engine.py``, single device).

* A fixed ``n_slots`` decode batch; each slot owns a stripe of the dense
  KV cache ``(L, n_slots, max_len, KV, hd)``, or (``cache="paged"``) the
  pool blocks its block table names (``serve/paging.py``): blocks are
  reserved at admission, allocated on append, freed on eviction, and when
  the pool runs dry mid-decode a slot is preempted (recompute: the
  request goes back to the queue front and later re-prefills ``prompt +
  output``).
* Admission by prefill wave: queued prompts are right-padded to a length
  bucketed to a multiple of ``seq_bucket``, prefilled in one call over
  ``n_slots`` rows, and their cache stripes scattered into free slots
  (``_admit`` -> ``_admit_prefill`` -> ``_insert_wave``).
* One fused decode step per tick for every slot (``dispatch_decode``),
  greedy sampling on the device (``_sample``), and one device-to-host
  copy of the sampled tokens per tick (``_postprocess``).
* Slots free on EOS, token budget or ``max_len``; the queue backfills on
  the next tick.

Serving the adapter-attached model (``peft=``, an ``AdapterSet``) is
numerically the merged model's (``core.peft.merge_all``);
``cfg.peft_backend="pallas"`` routes QuanTA (and quantized projections)
through the hand-written kernels and ``cfg.attn_backend="pallas"``
attention through the flash kernels.  ``base_quant="nf4"|"int8"`` packs
every projection into a blockwise ``QuantizedLinear`` at construction
(the QLoRA pattern: adapters stay full precision on top);
``kv_quant`` cross-checks ``cfg.kv_quant``, which makes the model store
NF4/int8 codes in the paged pools (the fake-quantized round trip in a
dense cache).  The decode step updates the cache in place: the stripes
of inactive slots hold entries past their length that every reader
masks, and their pool writes land in the null block.  Meshes, adapter
banks and pools, chunked prefill and replay admission are not ported
yet; PyTorch runs eagerly, so the JAX engine's compile guard has no
counterpart.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quantize import quantize_params
from repro_torch.kernels.dispatch import default_device
from repro_torch.models.common import insert_cache_slots, merge_cache_slots
from repro_torch.serve.paging import PagedCacheView, addressable_nbytes

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(
        self,
        model,
        params,
        peft=None,
        *,
        adapters=None,
        n_slots: int = 4,
        max_len: int = 256,
        seq_bucket: int = 16,
        cache: str = "dense",
        block_size: int = 16,
        n_blocks: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        mesh=None,
        base_quant: Optional[str] = None,
        kv_quant: Optional[str] = None,
        device=None,
    ):
        for name, value, default in (
            ("adapters", adapters, None),
            ("prefill_chunk", prefill_chunk, None), ("mesh", mesh, None),
        ):
            if value != default:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet: the port "
                    "serves one adapter set with prefill admission on one "
                    "device"
                )
        if cache not in ("dense", "paged"):
            raise ValueError(f"unknown cache mode {cache!r}")
        self.device = default_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model on {model.device}, engine asked for {self.device}"
            )
        self.model = model
        self.cfg = model.cfg
        # frozen-base quantization: every projection packed once here;
        # already quantized leaves are kept
        self.base_quant = base_quant
        if base_quant is not None:
            params = quantize_params(params, base_quant,
                                     block_size=self.cfg.quant_block_size)
        # the model quantizes KV on write (cfg.kv_quant); the engine knob
        # only cross-checks it
        cfg_kv = self.cfg.kv_quant
        if kv_quant is not None:
            if kv_quant not in ("nf4", "int8"):
                raise ValueError(f"unknown kv_quant format {kv_quant!r}")
            if cfg_kv is None:
                raise ValueError(
                    "kv_quant= requires the model cfg to set kv_quant "
                    "(the decode step quantizes KV on write)")
            if kv_quant != cfg_kv:
                raise ValueError(
                    f"engine kv_quant={kv_quant!r} conflicts with model "
                    f"cfg.kv_quant={cfg_kv!r}")
        self.kv_quant = cfg_kv
        self.params = params
        self.peft = peft
        self.n_slots = n_slots
        self.max_len = max_len
        self.seq_bucket = seq_bucket
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.spec = model.cache_spec()
        self.pager = (PagedCacheView(model, n_slots, max_len, block_size,
                                     n_blocks)
                      if cache == "paged" else None)
        self._paged = self.pager is not None and self.pager.paged
        # spec of the serving cache: with quantized pools it has the
        # ``*_qscale`` leaves that every cache surgery must see
        self.serve_spec = self.pager.serve_spec if self._paged else self.spec
        self.cache = (self.pager.init_cache() if self.pager is not None
                      else model.init_cache(n_slots, max_len))
        self._lengths = np.zeros((n_slots,), np.int32)      # host-side
        self._last_token = np.zeros((n_slots,), np.int32)
        self.stats: Dict[str, Any] = {
            "prefill_calls": 0, "decode_calls": 0, "tokens": 0,
            "preemptions": 0,
            "param_bytes": _tree_nbytes(self.params),
            "base_quant": base_quant or "none",
            "kv_quant": self.kv_quant or "none",
        }
        self._update_gauges()

    # ------------------------------------------------------------- frontend
    def submit(self, req: Request) -> None:
        self.validate(req)
        self.queue.append(req)

    def validate(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError("empty prompt")
        if len(req.prompt) >= self.max_len:
            raise ValueError("prompt longer than engine max_len")
        if self._paged:
            # a request that could never fit alone would livelock
            # admission and preemption
            worst = min(len(req.prompt) + req.max_new_tokens, self.max_len)
            need = self.pager.blocks_for(worst)
            usable = self.pager.max_request_blocks
            if need > usable:
                raise ValueError(
                    f"request needs up to {need} blocks but the pool only "
                    f"has {usable}; it could never be admitted")

    @staticmethod
    def _tokens(req: Request) -> List[int]:
        """Admission tokens: a preempted request re-admits with what it
        generated as part of its prompt (recompute preemption)."""
        return req.prompt + req.output if req.output else req.prompt

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _bucket(self, n: int) -> int:
        return min(-(-n // self.seq_bucket) * self.seq_bucket, self.max_len)

    def _update_gauges(self) -> None:
        if self.pager is not None:
            self.stats.update(self.pager.stats())
            self.stats["kv_quant"] = self.stats.get("kv_quant") or "none"
        elif "cache_bytes_allocated" not in self.stats:
            self.stats.update(
                blocks_in_use=0, blocks_total=0, peak_blocks_in_use=0,
                cache_bytes_allocated=_tree_nbytes(self.cache),
                peak_block_utilization=0.0)

    # ------------------------------------------------------------ admission
    def _admit(self) -> None:
        free = self._free_slots()
        if not free or not self.queue:
            return
        wave: List[Request] = []
        while self.queue and len(wave) < len(free):
            n_tok = len(self._tokens(self.queue[0]))
            if self._paged:
                if not self.pager.can_admit(n_tok):
                    break             # no room: wait for frees
                # reserve now, so later wave members and alloc-on-append
                # see the smaller pool
                self.pager.ensure(free[len(wave)], n_tok)
            wave.append(self.queue.popleft())
        if wave:
            self._admit_prefill(free, wave)

    def _admit_prefill(self, free: Sequence[int], wave: List[Request]) -> None:
        """One prefill over the right-padded wave, then scatter its cache
        stripes into the free slots."""
        streams = [self._tokens(r) for r in wave]
        lengths = np.array([len(p) for p in streams], np.int32)
        s = self._bucket(int(lengths.max()))
        toks = np.zeros((self.n_slots, s), np.int64)
        lens = np.ones((self.n_slots,), np.int32)     # dummy rows: length 1
        for row, p in enumerate(streams):
            toks[row, : len(p)] = p
            lens[row] = len(p)
        logits, wave_cache = self.model.prefill(
            self.params, self.peft,
            {"tokens": torch.from_numpy(toks).to(self.device)},
            lengths=torch.from_numpy(lens).to(self.device),
        )
        self.stats["prefill_calls"] += 1
        slot_ids = np.asarray(free[: len(wave)], np.int64)
        self._insert_wave(slot_ids, wave_cache, lengths)
        first = self._sample(logits).cpu().numpy()[:, 0]
        for row, (slot, req) in enumerate(zip(free, wave)):
            self.slots[slot] = req
            self._lengths[slot] = lengths[row]
            tok = int(first[row])
            self._last_token[slot] = tok
            req.output.append(tok)
            self.stats["tokens"] += 1
        self._update_gauges()

    def _insert_wave(self, slot_ids, wave_cache, lengths) -> None:
        """Land a prefill wave in the serving cache: by slot, or through
        the block tables after allocating each row's blocks."""
        if not self._paged:
            self.cache = self.model.insert_cache(
                self.cache, slot_ids, wave_cache, lengths)
            return
        for slot, n in zip(slot_ids, lengths):
            self.pager.ensure(int(slot), int(n))
        nb = -(-self.pager.wave_page_extent(wave_cache)
               // self.pager.block_size)
        tables = self.pager.wave_tables(slot_ids, nb)
        self.cache = insert_cache_slots(self.serve_spec, self.cache,
                                        slot_ids, wave_cache, lengths,
                                        block_tables=tables)

    def _preempt(self, slot: int) -> None:
        """Recompute preemption: free the slot's blocks and put its request
        back at the queue front; it re-admits with ``prompt + output`` as
        its prefix, which continues its greedy stream."""
        req = self.slots[slot]
        self.slots[slot] = None
        self.pager.release(slot)
        self.queue.appendleft(req)
        self.stats["preemptions"] += 1

    def _ensure_growth(self, active: np.ndarray) -> None:
        """Alloc on append: every active slot must hold one more token
        before the decode step.  When the pool is dry, preempt the highest
        active slot (it frees at least one block, so the retry cannot
        fail) and let the others decode; ``active`` is updated in place."""
        for i in range(self.n_slots):
            if not active[i]:
                continue
            try:
                self.pager.ensure(i, int(self._lengths[i]) + 1)
            except MemoryError:
                victim = max(j for j in range(self.n_slots) if active[j])
                self._preempt(victim)
                active[victim] = False
                if active[i]:
                    self.pager.ensure(i, int(self._lengths[i]) + 1)

    # ----------------------------------------------------------------- tick
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy tokens ``(B, 1)`` int32 from ``(B, 1, V)`` logits, on the
        device."""
        return torch.argmax(logits[:, :, : self.cfg.vocab_size], dim=-1
                            ).to(torch.int32)

    def dispatch_decode(self, toks: torch.Tensor, active: np.ndarray):
        """One fused decode step for the whole slot batch; returns the
        ``(B, 1, V)`` logits.  Only active slots advance their length."""
        tables = self.pager.device_tables() if self._paged else None
        logits, new_cache = self.model.decode_step(
            self.params, self.peft, self.cache, {"tokens": toks},
            block_tables=tables,
        )
        self.stats["decode_calls"] += 1
        self.cache = merge_cache_slots(self.serve_spec, new_cache,
                                       self.cache, active,
                                       skip_paged=self._paged)
        return logits

    def _postprocess(self, nxt: np.ndarray, active: np.ndarray) -> None:
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            tok = int(nxt[i])
            req.output.append(tok)
            self.stats["tokens"] += 1
            self._last_token[i] = tok
            self._lengths[i] += 1
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.output) >= req.max_new_tokens or \
                    self._lengths[i] >= self.max_len - 1:
                req.done = True
                self.slots[i] = None
                if self._paged:
                    self.pager.release(i)       # free on eviction
        if self._paged:
            self._update_gauges()

    def step(self) -> None:
        self._admit()
        active = np.array([r is not None for r in self.slots])
        if not active.any():
            return
        if self._paged:
            self._ensure_growth(active)
            if not active.any():
                return
        toks = torch.from_numpy(
            self._last_token.reshape(-1, 1).astype(np.int64)
        ).to(self.device)
        logits = self.dispatch_decode(toks, active)
        nxt = self._sample(logits).cpu().numpy()[:, 0]
        self._postprocess(nxt, active)

    def run(self, max_ticks: int = 10_000) -> None:
        ticks = 0
        while (self.queue or any(self.slots)) and ticks < max_ticks:
            self.step()
            ticks += 1


def _tree_nbytes(tree) -> int:
    """Device bytes of every tensor in a nested dict (quantized weights
    count their packed codes, scales and norms)."""
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return addressable_nbytes(tree)
    tensors = getattr(tree, "tensors", None)
    return sum(addressable_nbytes(t) for t in tensors()) if tensors else 0
