"""Continuous-batching serving engine, dense cache and prefill admission
(port of ``repro/serve/engine.py``).

* A fixed ``n_slots`` decode batch; each slot owns a stripe of the dense
  KV cache ``(L, n_slots, max_len, KV, hd)``.
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
``cfg.peft_backend="pallas"`` routes QuanTA through the hand-written
kernels and ``cfg.attn_backend="pallas"`` attention through the flash
kernels.  The decode step updates the cache in place, so the stripes of
inactive slots hold entries past their length that every reader masks.
Paging, meshes, adapter banks and pools, chunked prefill, replay
admission and quantization are not ported yet; PyTorch runs eagerly, so
the JAX engine's compile guard has no counterpart.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.dispatch import default_device
from repro_torch.models.common import merge_cache_slots

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
        prefill_chunk: Optional[int] = None,
        mesh=None,
        base_quant: Optional[str] = None,
        kv_quant: Optional[str] = None,
        device=None,
    ):
        for name, value, default in (
            ("adapters", adapters, None), ("cache", cache, "dense"),
            ("prefill_chunk", prefill_chunk, None), ("mesh", mesh, None),
            ("base_quant", base_quant, None), ("kv_quant", kv_quant, None),
        ):
            if value != default:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet: the port "
                    "serves a dense cache with prefill admission"
                )
        self.device = default_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model on {model.device}, engine asked for {self.device}"
            )
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.peft = peft
        self.n_slots = n_slots
        self.max_len = max_len
        self.seq_bucket = seq_bucket
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.spec = model.cache_spec()
        self.cache = model.init_cache(n_slots, max_len)
        self._lengths = np.zeros((n_slots,), np.int32)      # host-side
        self._last_token = np.zeros((n_slots,), np.int32)
        self.stats: Dict[str, Any] = {
            "prefill_calls": 0, "decode_calls": 0, "tokens": 0,
        }

    # ------------------------------------------------------------- frontend
    def submit(self, req: Request) -> None:
        self.validate(req)
        self.queue.append(req)

    def validate(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError("empty prompt")
        if len(req.prompt) >= self.max_len:
            raise ValueError("prompt longer than engine max_len")

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _bucket(self, n: int) -> int:
        return min(-(-n // self.seq_bucket) * self.seq_bucket, self.max_len)

    # ------------------------------------------------------------ admission
    def _admit(self) -> None:
        free = self._free_slots()
        if not free or not self.queue:
            return
        wave: List[Request] = []
        while self.queue and len(wave) < len(free):
            wave.append(self.queue.popleft())
        self._admit_prefill(free, wave)

    def _admit_prefill(self, free: Sequence[int], wave: List[Request]) -> None:
        """One prefill over the right-padded wave, then scatter its cache
        stripes into the free slots."""
        streams = [r.prompt for r in wave]
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

    def _insert_wave(self, slot_ids, wave_cache, lengths) -> None:
        self.cache = self.model.insert_cache(
            self.cache, slot_ids, wave_cache, lengths
        )

    # ----------------------------------------------------------------- tick
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy tokens ``(B, 1)`` int32 from ``(B, 1, V)`` logits, on the
        device."""
        return torch.argmax(logits[:, :, : self.cfg.vocab_size], dim=-1
                            ).to(torch.int32)

    def dispatch_decode(self, toks: torch.Tensor, active: np.ndarray):
        """One fused decode step for the whole slot batch; returns the
        ``(B, 1, V)`` logits.  Only active slots advance their length."""
        logits, new_cache = self.model.decode_step(
            self.params, self.peft, self.cache, {"tokens": toks}
        )
        self.stats["decode_calls"] += 1
        self.cache = merge_cache_slots(self.spec, new_cache, self.cache,
                                       active)
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

    def step(self) -> None:
        self._admit()
        active = np.array([r is not None for r in self.slots])
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
