"""Capture guard: runtime checks behind ``REPRO_SANITIZE=1`` (port of
``repro/analysis/sanitize.py``).

Every captured entry point of a ``ServingEngine`` is registered on a
:class:`CompileGuard` with its documented bound
(``ServingEngine.compilation_bounds``).  Where the JAX package counts the
traces in a function's jit cache, the port counts the CUDA graphs it has
captured: a registered callable exposes ``_cache_size()``, and the guard
raises :class:`RetraceError` when an entry point captured more graphs
than its bound -- the one-graph-per-engine discipline of the decode tick,
enforced at every tick rather than by one-off tests.  Callables without
``_cache_size`` (eager entry points: prefill waves, chunk steps, the
insert scatter) are skipped at registration, as in the JAX package.

The JAX module's ``install()`` (``jax_check_tracer_leaks`` and the
``backend_compile`` event counter) has no PyTorch counterpart: nothing is
traced, so nothing can leak from a trace, and graph captures are counted
by the entry points themselves.  It is left out.

Enable for a run with ``REPRO_SANITIZE=1``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

__all__ = ["CompileGuard", "RetraceError", "enabled"]


def enabled() -> bool:
    """True when ``REPRO_SANITIZE`` is set to a truthy value."""
    return os.environ.get("REPRO_SANITIZE", "").lower() in (
        "1", "true", "yes", "on",
    )


class RetraceError(AssertionError):
    """An entry point captured more graphs than its documented bound."""


@dataclasses.dataclass
class _Entry:
    fn: Callable
    bound: int

    def cache_size(self) -> int:
        return self.fn._cache_size()


class CompileGuard:
    """Tracks captured entry points against their capture bounds.

    Each registered callable's ``_cache_size()`` -- the number of graphs
    it has captured -- must stay within its ``bound``.  Eager callables
    (no ``_cache_size``) are skipped at registration, so callers can
    register unconditionally.
    """

    def __init__(self, name: str = "engine"):
        self.name = name
        self._entries: Dict[str, _Entry] = {}

    def register(self, name: str, fn: Optional[Callable],
                 bound: int) -> None:
        """Track ``fn`` under ``name``; no-op for ``None`` or eager fns."""
        if fn is None or not hasattr(fn, "_cache_size"):
            return
        self._entries[name] = _Entry(fn, bound)

    @property
    def entry_points(self) -> List[str]:
        return sorted(self._entries)

    def counts(self) -> Dict[str, int]:
        """Current capture count per registered entry point."""
        return {n: e.cache_size() for n, e in sorted(self._entries.items())}

    def bounds(self) -> Dict[str, int]:
        return {n: e.bound for n, e in sorted(self._entries.items())}

    def violations(self) -> List[str]:
        out = []
        for name, entry in sorted(self._entries.items()):
            n = entry.cache_size()
            if n > entry.bound:
                out.append(
                    f"{self.name}.{name}: {n} captures exceed the "
                    f"documented bound of {entry.bound} -- a graph was "
                    "captured again (a shape or a buffer changed)"
                )
        return out

    def assert_ok(self) -> None:
        """Raise :class:`RetraceError` if any entry point exceeds its bound."""
        bad = self.violations()
        if bad:
            raise RetraceError("; ".join(bad))
