"""SLA-aware scheduling for the serving front end (port of
``repro/serve/scheduler.py``; host-side policy, the same decisions on the
same sequences).

It owns no device state and never imports the engine.  Pieces:

* :class:`SLAClass` / :class:`SLAScheduler` -- latency-class queues
  (default ``interactive`` / ``batch``) with earliest-deadline-first
  admission across classes: a request's deadline is ``arrival_time +
  class.ttft_target``, FIFO within a class, and preemption requeues at
  the front.  ``view(now)`` adapts the class queues to the deque protocol
  ``ServingEngine._admit`` consumes (``bool`` / ``[0]`` / ``popleft``),
  gated on ``arrival_time <= now`` so that a pre-submitted open-loop
  schedule releases with the clock.
* :meth:`SLAScheduler.pick_victim` -- SLA-aware preemption victims for
  ``ServingEngine.victim_hook``: the lowest-priority class first, then the
  latest arrival, then the highest slot.
* :class:`InterleavePolicy` -- how many chunked-prefill steps the front
  end runs a tick (in place of the engine's one chunk a tick).
* :class:`VirtualClock` and :func:`poisson_arrivals` -- deterministic time
  and the open-loop Poisson load shape.
* ``LatencyHistogram`` lives in ``serve/metrics.py`` and is re-exported.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.metrics import LatencyHistogram

__all__ = [
    "SLAClass",
    "SLAScheduler",
    "InterleavePolicy",
    "LatencyHistogram",
    "VirtualClock",
    "DEFAULT_CLASSES",
    "poisson_arrivals",
]


# --------------------------------------------------------------- clocks

class VirtualClock:
    """Deterministic clock for scheduler tests: ``clock()`` returns a
    manually advanced time, so seeded arrival schedules release
    identically on every run regardless of wall time."""

    def __init__(self, start: float = 0.0):
        self.now = start

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now

    def __call__(self) -> float:
        return self.now


def poisson_arrivals(
    rng: np.random.Generator, rate: float, n: int, start: float = 0.0,
) -> np.ndarray:
    """``n`` cumulative Poisson-process arrival times at ``rate``
    requests/second, starting at ``start`` — the open-loop load shape
    (arrivals independent of service times)."""
    if rate <= 0:
        raise ValueError("arrival rate must be positive")
    gaps = rng.exponential(1.0 / rate, size=n)
    return start + np.cumsum(gaps)


# ------------------------------------------------------------ SLA queues

@dataclasses.dataclass(frozen=True)
class SLAClass:
    """One latency class: ``priority`` orders preemption victims (higher
    number = evicted first) and ``ttft_target`` (seconds) sets both the
    EDF deadline (``arrival + target``) and the goodput SLO the load
    harness reports against."""

    name: str
    priority: int
    ttft_target: float


DEFAULT_CLASSES = (
    SLAClass("interactive", priority=0, ttft_target=0.25),
    SLAClass("batch", priority=1, ttft_target=2.5),
)


class _ReadyView:
    """Adapts the scheduler's EDF selection to the deque protocol that
    ``ServingEngine._admit`` consumes: truthiness, ``[0]`` peek, and
    ``popleft``.  Only requests with ``arrival_time <= now`` are
    visible, so a pre-submitted open-loop schedule releases with the
    clock."""

    def __init__(self, sched: "SLAScheduler", now: float):
        self._sched = sched
        self._now = now

    def __bool__(self) -> bool:
        return self._sched._best(self._now) is not None

    def __len__(self) -> int:
        return self._sched.ready_count(self._now)

    def __getitem__(self, i: int):
        if i != 0:
            raise IndexError("ready view only exposes the head")
        name = self._sched._best(self._now)
        if name is None:
            raise IndexError("no ready request")
        return self._sched.queues[name][0]

    def popleft(self):
        name = self._sched._best(self._now)
        if name is None:
            raise IndexError("no ready request")
        return self._sched.queues[name].popleft()


class SLAScheduler:
    """Latency-class queues with EDF admission and SLA-aware preemption.

    Requests carry ``latency_class`` / ``arrival_time``
    (``repro_torch.serve.Request``); :meth:`submit` validates the class and
    appends FIFO.  Admission order across classes is earliest deadline
    first, where ``deadline = arrival_time + class.ttft_target`` — an
    interactive request due in 250ms outranks a batch request due in
    2.5s until the batch deadline ages past it (no starvation: EDF lets
    overdue batch work through).  Preempted requests re-enter at the
    FRONT of their class queue with their original ``arrival_time``
    (preserved — the engine requeues the same ``Request`` object), so
    they hold the earliest deadline in their class.
    """

    def __init__(self, classes: Sequence[SLAClass] = DEFAULT_CLASSES):
        if not classes:
            raise ValueError("need at least one SLA class")
        self.classes: Dict[str, SLAClass] = {c.name: c for c in classes}
        if len(self.classes) != len(classes):
            raise ValueError("duplicate SLA class names")
        self.queues: Dict[str, deque] = {c.name: deque() for c in classes}

    # ------------------------------------------------------------ intake
    def submit(self, req) -> None:
        """Queue ``req`` in its class (FIFO).  The caller (the front end)
        has already validated/stamped it via ``ServingEngine.validate``."""
        if req.latency_class not in self.queues:
            raise ValueError(
                f"request {req.uid} names unknown latency class "
                f"{req.latency_class!r} (have {sorted(self.queues)})"
            )
        self.queues[req.latency_class].append(req)

    def requeue(self, req) -> None:
        """Preemption requeue: FRONT of the class queue.  The request
        object is reused, so ``arrival_time``/``latency_class`` (and the
        already-generated ``output`` prefix) survive preemption."""
        self.queues[req.latency_class].appendleft(req)

    # --------------------------------------------------------- selection
    def deadline(self, req) -> float:
        cls = self.classes[req.latency_class]
        return (req.arrival_time or 0.0) + cls.ttft_target

    def _best(self, now: float) -> Optional[str]:
        """Class whose ready head has the earliest deadline (ties: class
        priority, then name for determinism); None when nothing ready."""
        best = None
        for name, q in self.queues.items():
            if not q or (q[0].arrival_time or 0.0) > now:
                continue
            key = (self.deadline(q[0]), self.classes[name].priority, name)
            if best is None or key < best[0]:
                best = (key, name)
        return best[1] if best else None

    def view(self, now: float) -> _ReadyView:
        return _ReadyView(self, now)

    def has_ready(self, now: float) -> bool:
        return self._best(now) is not None

    def ready_count(self, now: float) -> int:
        return sum(
            1 for q in self.queues.values()
            for r in q if (r.arrival_time or 0.0) <= now
        )

    def pending(self) -> bool:
        return any(self.queues.values())

    def next_arrival(self) -> Optional[float]:
        """Earliest queued arrival time (for idle waits); None if empty."""
        heads = [q[0].arrival_time or 0.0 for q in self.queues.values() if q]
        return min(heads) if heads else None

    def depths(self) -> Dict[str, int]:
        """Per-class queue depth — the ``queue_depth{class}`` gauge."""
        return {name: len(q) for name, q in self.queues.items()}

    # -------------------------------------------------------- preemption
    def pick_victim(self, candidates: Sequence[int], slots: List) -> int:
        """SLA-aware preemption victim among ``candidates`` (slot ids
        whose requests share the exhausted block arena): lowest-priority
        class first, then the latest arrival (least completed work
        thrown away under recompute-preemption), then the highest slot
        id.  Plugged into ``ServingEngine.victim_hook``."""

        def key(i: int):
            req = slots[i]
            cls = self.classes.get(getattr(req, "latency_class", ""))
            prio = cls.priority if cls is not None else max(
                c.priority for c in self.classes.values()
            )
            return (prio, req.arrival_time or 0.0, i)

        return max(candidates, key=key)


# ------------------------------------------------------ interleave policy

@dataclasses.dataclass
class InterleavePolicy:
    """Prefill/decode interleave for chunked admission.

    The closed-loop engine advances an in-flight chunked prefill by
    exactly ONE chunk per tick — a fixed cadence that couples admission
    latency to decode progress.  The front end instead asks this policy
    how many chunk steps to run each tick:

    * ``idle_burst`` when no decode slots are active (nothing to
      interleave with — finish admission as fast as the device allows),
    * ``urgent_burst`` while decoding, when the admitting request's SLA
      class has priority 0 (interactive admission jumps the cadence),
    * ``busy_burst`` otherwise (the engine's old one-chunk-per-tick
      behaviour is ``busy_burst=1``).
    """

    idle_burst: int = 1 << 16
    busy_burst: int = 1
    urgent_burst: int = 2

    def chunk_steps(self, decoding: bool, priority: Optional[int]) -> int:
        """Chunk steps to run this tick for an in-flight chunked
        admission whose request has SLA ``priority`` (None = unknown)."""
        if not decoding:
            return self.idle_burst
        if priority == 0:
            return self.urgent_burst
        return self.busy_burst
