"""Streaming continuous-batching front end over ``ServingEngine`` (port
of ``repro/serve/frontend.py``).

``ServeFrontend`` turns the engine's closed tick loop into a host loop
that overlaps host work with device ticks and streams tokens as they land:

* **SLA-aware continuous batching** -- ``submit()`` routes requests into
  latency-class queues (``serve/scheduler.SLAScheduler``, default
  ``interactive`` / ``batch``) and admission each tick pulls from the
  earliest-deadline-first ready view instead of the engine's queue.
  Preemption requeues into the class queues (``engine.requeue_hook``) and
  picks SLA-aware victims (``engine.victim_hook``: the lowest-priority
  class, then the latest arrival).
* **Double-buffered dispatch** -- a decode tick is one graph replay on
  the card (``ServingEngine.dispatch_decode``), queued without waiting.
  When every in-flight slot provably survives the tick not yet landed,
  the next tick is dispatched at once: tick N's sampled tokens chain into
  tick N+1's replay on the device (the graph's token merge ``where(fresh,
  host, chain)``: slots admitted in between take their token from the
  host), and only then does the host wait for tick N's tokens.  Those
  land through one device-to-host copy into a pinned buffer, with its own
  CUDA event, queued right after tick N's replay -- never read from the
  graph's output buffer, which tick N+1's replay overwrites.
* **Survival rule** (chain safety): a chained dispatch is issued only
  when no in-flight slot can complete in the un-landed tick (no
  ``eos_id``, token budget and ``max_len`` headroom >= 2, and (paged)
  blocks for both pending tokens without a preemption).  Anything else
  lands first, so streamed outputs equal the closed loop's token for
  token.
* **Streaming** -- ``submit()`` returns a :class:`TokenStream`: iterate
  it (``for tok in stream`` or ``async for tok in stream``) to receive
  tokens as their tick lands; ``result()`` blocks until the request is
  done.
* **Prefill/decode interleave** -- the engine's one chunk a tick of
  chunked prefill is replaced by ``scheduler.InterleavePolicy``.

``stats`` counts ``ticks``, ``chained`` (dispatches that skipped the host
round trip) and ``host_dispatch`` (dispatches from host tokens).  The
token merge is part of the engine's decode graph, so the front end adds
no entry point to ``engine.compile_guard``; ``tick()`` asserts its bounds
under ``REPRO_SANITIZE=1`` as ``ServingEngine.step`` does.
"""

from __future__ import annotations

import asyncio
import queue as _queue
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.analysis import sanitize
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import (
    DEFAULT_CLASSES, InterleavePolicy, SLAClass, SLAScheduler, VirtualClock,
)

__all__ = ["ServeFrontend", "TokenStream"]

_SENTINEL = object()


class TokenStream:
    """Per-request streaming handle returned by :meth:`ServeFrontend.submit`.

    Tokens arrive as their tick LANDS (one dispatch late under double
    buffering, but in generation order and before the next tick's
    tokens).  One consumer per stream:

    * ``for tok in stream`` — blocking iteration (front end driven by
      another thread, or already drained),
    * ``async for tok in stream`` — the blocking get runs in the
      default executor so the event loop (e.g. ``frontend.serve()``)
      stays live,
    * ``stream.result()`` — drain to completion, return the full list.

    ``tokens`` / ``token_times`` accumulate every landed token and its
    engine-clock timestamp (the open-loop harness computes exact
    TTFT / per-token-latency percentiles from them).
    """

    def __init__(self, req: Request, clock):
        self.request = req
        self._clock = clock
        self._q: _queue.Queue = _queue.Queue()
        self.tokens: List[int] = []
        self.token_times: List[float] = []
        self.closed = False

    @property
    def done(self) -> bool:
        return self.request.done

    # producer side (the front end) -----------------------------------
    def _push(self, tok: int) -> None:
        self.tokens.append(tok)
        self.token_times.append(self._clock())
        self._q.put(tok)

    def _close(self) -> None:
        self.closed = True
        self._q.put(_SENTINEL)

    # consumer side ---------------------------------------------------
    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            yield item

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        item = await asyncio.get_running_loop().run_in_executor(
            None, self._q.get
        )
        if item is _SENTINEL:
            raise StopAsyncIteration
        return item

    def result(self) -> List[int]:
        """Block until the stream closes; returns the full token list."""
        for _ in self:
            pass
        return self.tokens


class ServeFrontend:
    """SLA-scheduled, double-buffered, streaming front end.

    Drives a prefill-admission :class:`ServingEngine` through its
    front-end seams (``validate`` / ``_admit(queue=...)`` /
    ``dispatch_decode`` / ``_postprocess`` / the requeue+victim hooks).
    The engine's own FIFO stays empty; all queueing lives in the
    :class:`SLAScheduler`.

    ``stats``: ``ticks`` (front-end scheduling ticks), ``chained``
    (double-buffered dispatches that skipped the host round-trip),
    ``host_dispatch`` (synchronous fallbacks), plus the engine's own
    gauges (``engine.stats`` — ``queue_depth`` is overwritten each tick
    from the scheduler's class queues).
    """

    def __init__(
        self,
        engine: ServingEngine,
        classes: Sequence[SLAClass] = DEFAULT_CLASSES,
        interleave: Optional[InterleavePolicy] = None,
    ):
        if engine.admission != "prefill":
            raise ValueError(
                "ServeFrontend requires prefill admission: replay admission "
                "replays prompts through the decode tick and cannot overlap "
                "with in-flight decode ticks"
            )
        if engine.queue:
            raise ValueError(
                "engine already has queued requests; submit through the "
                "front end instead"
            )
        self.engine = engine
        self.scheduler = SLAScheduler(classes)
        self.interleave = interleave or InterleavePolicy()
        engine.requeue_hook = self.scheduler.requeue
        engine.victim_hook = self.scheduler.pick_victim
        self._streams: Dict[int, TokenStream] = {}
        self._emitted: Dict[int, int] = {}
        # the un-landed tick: (its tokens' landing, its dispatch-time
        # active mask).  At most one: tick N+1's dispatch lands tick N in
        # the same tick() call.
        self._inflight = None
        self.stats: Dict[str, int] = {
            "ticks": 0, "chained": 0, "host_dispatch": 0,
        }

    # ------------------------------------------------------------- intake
    def submit(
        self, req: Request, adapter: Optional[str] = None
    ) -> TokenStream:
        """Validate ``req``, queue it in its latency class, and return
        its :class:`TokenStream`.  ``req.arrival_time`` may be set to a
        FUTURE engine-clock time (open-loop load: the scheduler releases
        it when the clock reaches it); unset stamps now."""
        if req.uid in self._streams:
            raise ValueError(f"request uid {req.uid} already in flight")
        self.engine.validate(req, adapter)
        self.scheduler.submit(req)
        stream = TokenStream(req, self.engine.clock)
        self._streams[req.uid] = stream
        self._emitted[req.uid] = 0
        return stream

    def pending(self) -> bool:
        return (
            self.scheduler.pending()
            or any(s is not None for s in self.engine.slots)
            or self.engine._chunking is not None
            or self._inflight is not None
        )

    # ------------------------------------------------------ double buffer
    def _chain_safe(self) -> bool:
        """True when EVERY slot active in the un-landed tick provably
        survives it: no ``eos_id`` (any sampled token could be EOS),
        token budget and ``max_len`` headroom for one more tick after
        the pending one.  Paged capacity is checked separately
        (:meth:`_ensure_chain`) after admission."""
        if self._inflight is None:
            return False
        eng = self.engine
        _, act = self._inflight
        for i in range(eng.n_slots):
            if not act[i]:
                continue
            req = eng.slots[i]
            if req is None or req.eos_id is not None:
                return False
            if len(req.output) + 1 >= req.max_new_tokens:
                return False
            if int(eng._lengths[i]) + 1 >= eng.max_len - 1:
                return False
        return True

    def _ensure_chain(self, active: np.ndarray) -> bool:
        """Reserve paged blocks for BOTH pending tokens of a chained
        dispatch: an in-flight slot lands one token and immediately
        decodes another (capacity ``len+2``); a freshly admitted slot
        only decodes (``len+1``).  Returns False — fall back to the
        synchronous land-then-dispatch path — if any arena is exhausted
        (blocks already granted stay reserved; a completing victim
        releases them, and the fallback's ``_ensure_growth`` preempts
        through the same arenas otherwise)."""
        eng = self.engine
        if not eng._paged:
            return True
        _, act = self._inflight
        try:
            for i in range(eng.n_slots):
                if act[i]:
                    eng.pager.ensure(i, int(eng._lengths[i]) + 2)
                elif active[i]:
                    eng.pager.ensure(i, int(eng._lengths[i]) + 1)
        except MemoryError:
            return False
        return True

    def _land_inflight(self) -> None:
        """Wait for the un-landed tick's tokens (its one device-to-host
        copy) and run the engine's postprocess under its dispatch-time
        active mask."""
        landing, act = self._inflight
        self._inflight = None
        self.engine._postprocess(landing.tokens(), act)

    def _dispatch(self, active: np.ndarray,
                  fresh: Optional[np.ndarray] = None) -> None:
        """Dispatch one decode tick from the host tokens (of the ``fresh``
        slots only, when given: the others chain the previous tick's
        tokens on the device) and hold its landing as the in-flight tick
        (no wait here)."""
        eng = self.engine
        eng.dispatch_decode(eng._last_token, active, fresh)
        self._inflight = (eng._landing, active.copy())

    # ------------------------------------------------------------- tick
    def tick(self) -> bool:
        """One front-end scheduling tick: chunk burst, EDF admission,
        chained-or-host decode dispatch, then land the previous tick.
        Returns True when any work was done (False = idle: nothing
        ready before the next scheduled arrival)."""
        eng = self.engine
        t0 = eng.clock()
        did = False

        # 1) chunked-prefill burst per the interleave policy
        if eng._chunking is not None:
            decoding = (
                self._inflight is not None
                or any(s is not None for s in eng.slots)
            )
            cls = self.scheduler.classes.get(
                eng._chunking["req"].latency_class
            )
            steps = self.interleave.chunk_steps(
                decoding, cls.priority if cls is not None else None
            )
            for _ in range(steps):
                if eng._chunking is None:
                    break
                eng._step_chunked()
                did = True

        # 2) land BEFORE admission when the un-landed tick may complete
        # a request — its freed slots then admit this very tick.
        if self._inflight is not None and not self._chain_safe():
            self._land_inflight()
            did = True

        # 3) EDF admission from the scheduler's ready view
        eng._admit(queue=self.scheduler.view(eng.clock()), chunk=False)
        active = np.array([s is not None for s in eng.slots])

        # 4) decode dispatch: chained (double-buffered) when safe
        if self._inflight is not None:
            if self._ensure_chain(active):
                landing_old, act_old = self._inflight
                self._dispatch(active, fresh=eng._fresh)
                self.stats["chained"] += 1
                # the older tick lands while the new one runs
                eng._postprocess(landing_old.tokens(), act_old)
                did = True
            else:
                # arena full: land (chain-safe held, so nothing
                # completes), preempt through the SLA victim hook, and
                # dispatch synchronously from host tokens.
                self._land_inflight()
                active = np.array([s is not None for s in eng.slots])
                eng._ensure_growth(active)
                if active.any():
                    self._dispatch(active)
                    self.stats["host_dispatch"] += 1
                    did = True
        elif active.any():
            if eng._paged:
                eng._ensure_growth(active)
            if active.any():
                self._dispatch(active)
                self.stats["host_dispatch"] += 1
                did = True

        # 5) stream landed tokens; refresh gauges
        self._flush_streams()
        self.stats["ticks"] += 1
        depths = self.scheduler.depths()
        eng.stats["queue_depth"] = depths
        peak = eng.stats.setdefault("queue_depth_peak", {})
        for name, depth in depths.items():
            peak[name] = max(peak.get(name, 0), depth)
        if did:
            eng.tick_hist.record(max(eng.clock() - t0, 0.0))
        if sanitize.enabled():
            eng.compile_guard.assert_ok()
        return did

    def _flush_streams(self) -> None:
        """Push every landed-but-unstreamed token to its stream; close
        and retire streams whose requests completed."""
        finished = []
        for uid, stream in self._streams.items():
            req = stream.request
            sent = self._emitted[uid]
            for tok in req.output[sent:]:
                stream._push(tok)
            self._emitted[uid] = len(req.output)
            if req.done:
                stream._close()
                finished.append(uid)
        for uid in finished:
            del self._streams[uid]
            del self._emitted[uid]

    # ------------------------------------------------------------- loops
    def _idle(self) -> None:
        """Nothing ready: wait for the next scheduled arrival (advance a
        virtual clock directly; nap a real one)."""
        nxt = self.scheduler.next_arrival()
        if nxt is None:
            return
        clk = self.engine.clock
        if isinstance(clk, VirtualClock):
            if nxt > clk.now:
                clk.now = nxt
        else:
            time.sleep(min(max(nxt - clk(), 0.0), 0.001))

    def drain(self, max_ticks: int = 100_000) -> None:
        """Run ticks until every submitted request has completed (the
        synchronous loop — threads/benchmarks; tests with a virtual
        clock drive :meth:`tick` directly)."""
        ticks = 0
        while self.pending() and ticks < max_ticks:
            if not self.tick():
                self._idle()
            ticks += 1
        if self._inflight is not None:
            self._land_inflight()
            self._flush_streams()

    async def serve(self, max_ticks: int = 100_000) -> None:
        """Async loop: the same ticks as :meth:`drain` but yields to the
        event loop every tick so ``async for tok in stream`` consumers
        interleave with the scheduler."""
        ticks = 0
        while self.pending() and ticks < max_ticks:
            busy = self.tick()
            if not busy:
                self._idle()
            await asyncio.sleep(0)
            ticks += 1
        if self._inflight is not None:
            self._land_inflight()
            self._flush_streams()
