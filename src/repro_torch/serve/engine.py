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
numerically the merged model's (``core.peft.merge_all``).
``adapters=`` (a ``core.bank.AdapterBank`` or a
``serve.adapter_pool.AdapterPool``) serves many tenants over one base:
``submit(req, adapter="name")`` names each request's tenant (``None`` the
base model), the engine keeps a per-slot global id (0 for pad rows and
free slots) and hands the batch's ids to every model call, copied to the
device once per call.  With a pool, admission pins the request's tenant
(loading it, maybe evicting an idle one) as its last check and defers the
request when no row can be freed; freeing or preempting a slot unpins.
``cfg.peft_backend="pallas"`` routes QuanTA (and quantized projections)
through the hand-written kernels and ``cfg.attn_backend="pallas"``
attention through the flash kernels.  ``base_quant="nf4"|"int8"`` packs
every projection into a blockwise ``QuantizedLinear`` at construction
(the QLoRA pattern: adapters stay full precision on top);
``kv_quant`` cross-checks ``cfg.kv_quant``, which makes the model store
NF4/int8 codes in the paged pools (the fake-quantized round trip in a
dense cache).  The decode step updates the cache in place: the stripes
of inactive slots hold entries past their length that every reader
masks, and their pool writes land in the null block.  Meshes, chunked
prefill and replay admission are not ported yet; PyTorch runs eagerly,
so the JAX engine's compile guard has no counterpart.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.adapters import tree_nbytes
from repro_torch.core.bank import AdapterBank
from repro_torch.core.quantize import quantize_params
from repro_torch.kernels.dispatch import default_device
from repro_torch.models.common import insert_cache_slots, merge_cache_slots
from repro_torch.serve.adapter_pool import AdapterPool
from repro_torch.serve.paging import PagedCacheView

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # the bank tenant to decode with (None = the base model; engines built
    # with adapters= only)
    adapter: Optional[str] = None
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
        for name, value in (("prefill_chunk", prefill_chunk),
                            ("mesh", mesh)):
            if value is not None:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet: the port "
                    "serves with prefill admission on one device")
        if adapters is not None:
            if not isinstance(adapters, (AdapterBank, AdapterPool)):
                raise TypeError(
                    f"adapters= takes an AdapterBank or an AdapterPool, got "
                    f"{type(adapters).__name__}")
            if peft is not None:
                raise ValueError(
                    "pass either peft= (one adapter set for every request) "
                    "or adapters= (an AdapterBank with per-request "
                    "selection)")
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
        # bank mode: ``bank`` resolves tenant names, ``peft`` is what the
        # model reads (a pool's resident bank, swapped in place)
        self.bank = adapters
        self.pool = adapters if isinstance(adapters, AdapterPool) else None
        self.peft = (self.pool.device_bank() if self.pool is not None
                     else adapters if adapters is not None else peft)
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
        # per-slot global tenant ids (0 = base model), bank mode only
        self._adapter_ids = np.zeros((n_slots,), np.int32)
        # adapter bytes: resident (what the ticks read: one set, a static
        # bank or the pool's rows) and registry (a pool's tenants)
        if self.pool is not None:
            resident_b = self.pool.resident_nbytes()
            registry_b = self.pool.store.nbytes
        else:
            resident_b = (self.bank.nbytes if self.bank is not None
                          else tree_nbytes(getattr(peft, "tree", peft)
                                            or {}))
            registry_b = 0
        self.stats: Dict[str, Any] = {
            "prefill_calls": 0, "decode_calls": 0, "tokens": 0,
            "preemptions": 0,
            "adapter_bytes": resident_b,
            "adapter_bytes_resident": resident_b,
            "adapter_bytes_registry": registry_b,
            "adapter_tenants": (self.bank.num_tenants
                                if self.bank is not None else 0),
            "param_bytes": tree_nbytes(self.params),
            "base_quant": base_quant or "none",
            "kv_quant": self.kv_quant or "none",
        }
        self._update_gauges()

    # ------------------------------------------------------------- frontend
    def submit(self, req: Request, adapter: Optional[str] = None) -> None:
        """Queue a request; ``adapter`` (or ``req.adapter``) names its bank
        tenant, ``None`` the base model."""
        self.validate(req, adapter)
        self.queue.append(req)

    def validate(self, req: Request, adapter: Optional[str] = None) -> None:
        """Check ``req`` against this engine and stamp its tenant, without
        queueing it; an unknown tenant fails here."""
        name = adapter if adapter is not None else req.adapter
        if name is not None and self.bank is None:
            raise ValueError(
                f"request {req.uid} names adapter {name!r} but the engine "
                "has no AdapterBank (pass adapters= at construction)")
        if self.bank is not None:
            self.bank.id_of(name)
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
        if adapter is not None:
            req.adapter = adapter        # stamped once fully validated

    def _req_adapter_id(self, req: Request) -> int:
        return self.bank.id_of(req.adapter) if self.bank is not None else 0

    def _device_ids(self, ids: np.ndarray) -> Optional[torch.Tensor]:
        """The per-row tenant ids of one model call, on the device (bank
        mode), else None."""
        if self.bank is None:
            return None
        return torch.from_numpy(ids).to(self.device)

    def _acquire_adapter(self, req: Request) -> bool:
        """Pool mode: pin the request's tenant, loading it if needed;
        False defers the request.  Static banks are always ready."""
        return self.pool is None or self.pool.acquire(req.adapter)

    def _release_adapter(self, req: Request) -> None:
        """Pool mode: unpin when the request leaves its slot."""
        if self.pool is not None:
            self.pool.release(req.adapter)

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
        if self.pool is not None:
            self.stats.update(self.pool.stats())
            self.stats["adapter_bytes"] = self.stats["adapter_bytes_resident"]
        if self.pager is not None:
            self.stats.update(self.pager.stats())
            self.stats["kv_quant"] = self.stats.get("kv_quant") or "none"
        elif "cache_bytes_allocated" not in self.stats:
            self.stats.update(
                blocks_in_use=0, blocks_total=0, peak_blocks_in_use=0,
                cache_bytes_allocated=tree_nbytes(self.cache),
                peak_block_utilization=0.0)

    # ------------------------------------------------------------ admission
    def _admit(self) -> None:
        free = self._free_slots()
        if not free or not self.queue:
            return
        wave: List[Request] = []
        while self.queue and len(wave) < len(free):
            n_tok = len(self._tokens(self.queue[0]))
            if self._paged and not self.pager.can_admit(n_tok):
                break                 # no room: wait for frees
            if not self._acquire_adapter(self.queue[0]):
                break                 # tenant cannot be loaded: defer
            if self._paged:
                # reserve now, so later wave members and alloc-on-append
                # see the smaller pool
                self.pager.ensure(free[len(wave)], n_tok)
            wave.append(self.queue.popleft())
        if wave:
            self._admit_prefill(free, wave)
        elif self.pool is not None:
            self._update_gauges()     # a deferral moves the pool's gauges

    def _admit_prefill(self, free: Sequence[int], wave: List[Request]) -> None:
        """One prefill over the right-padded wave, then scatter its cache
        stripes into the free slots."""
        streams = [self._tokens(r) for r in wave]
        lengths = np.array([len(p) for p in streams], np.int32)
        s = self._bucket(int(lengths.max()))
        toks = np.zeros((self.n_slots, s), np.int64)
        lens = np.ones((self.n_slots,), np.int32)     # dummy rows: length 1
        wave_ids = np.zeros((self.n_slots,), np.int32)  # dummy rows: base
        for row, (p, req) in enumerate(zip(streams, wave)):
            toks[row, : len(p)] = p
            lens[row] = len(p)
            wave_ids[row] = self._req_adapter_id(req)
        logits, wave_cache = self.model.prefill(
            self.params, self.peft,
            {"tokens": torch.from_numpy(toks).to(self.device)},
            lengths=torch.from_numpy(lens).to(self.device),
            adapter_ids=self._device_ids(wave_ids),
        )
        self.stats["prefill_calls"] += 1
        slot_ids = np.asarray(free[: len(wave)], np.int64)
        self._insert_wave(slot_ids, wave_cache, lengths)
        first = self._sample(logits).cpu().numpy()[:, 0]
        for row, (slot, req) in enumerate(zip(free, wave)):
            self.slots[slot] = req
            self._lengths[slot] = lengths[row]
            self._adapter_ids[slot] = wave_ids[row]
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
        self._adapter_ids[slot] = 0
        self.pager.release(slot)
        # unpin: the tenant may be evicted while the request waits, and
        # re-admission acquires it again (the request keeps its tenant)
        self._release_adapter(req)
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
            adapter_ids=self._device_ids(self._adapter_ids),
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
                self._adapter_ids[i] = 0      # freed slots decode as base
                self._release_adapter(req)
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
