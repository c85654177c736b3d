"""Serving metrics of the port: the JAX package's ``LatencyHistogram``
(``repro/serve/scheduler.py``), behind the engine's tick and TTFT gauges
and the adapter pool's swap gauge.  ``serve/scheduler.py`` re-exports it
(the port keeps one copy)."""

from __future__ import annotations

import bisect
import math
from typing import Dict

__all__ = ["LatencyHistogram"]


class LatencyHistogram:
    """Log2-bucketed latency histogram (seconds).

    Bucket ``i`` covers ``[lo * 2**i, lo * 2**(i+1))``; with ``lo=1e-6``
    and 28 buckets the range is 1 us .. ~134 s.  ``percentile`` answers at
    the geometric midpoint of the bucket holding the requested rank (at
    most 41% off per value), clamped to the largest value recorded.
    """

    def __init__(self, lo: float = 1e-6, n_buckets: int = 28):
        self.lo = lo
        self.counts = [0] * n_buckets
        # upper edges as the same float products callers build edge values
        # from, so an exact edge lo * 2**k lands in bucket k
        self._edges = [lo * 2.0 ** (i + 1) for i in range(n_buckets - 1)]
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def _bucket(self, seconds: float) -> int:
        if seconds <= self.lo:
            return 0
        return bisect.bisect_right(self._edges, seconds)

    def record(self, seconds: float) -> None:
        self.counts[self._bucket(seconds)] += 1
        self.count += 1
        self.total += seconds
        self.max = max(self.max, seconds)

    def merge(self, other: "LatencyHistogram") -> None:
        """Add ``other``'s records (same ``lo`` and bucket count) to this
        histogram."""
        if (other.lo, len(other.counts)) != (self.lo, len(self.counts)):
            raise ValueError("histograms with other buckets cannot merge")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.max = max(self.max, other.max)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Approximate p-th percentile (p in [0, 100]); 0.0 when empty.
        The rank is ``max(1, ceil(p/100 * count))``."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return min(self.lo * 2.0 ** (i + 0.5), self.max)
        return self.max

    def to_dict(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_s": self.mean,
            "max_s": self.max,
            "p50_s": self.percentile(50),
            "p99_s": self.percentile(99),
        }
