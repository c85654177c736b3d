"""Capture guard: runtime checks behind ``REPRO_SANITIZE=1`` (port of
``repro/analysis/sanitize.py``).

Two mechanisms:

* **Capture counting** -- every captured entry point of a
  ``ServingEngine`` is registered on a :class:`CompileGuard` with its
  documented bound (``ServingEngine.compilation_bounds``).  Where the JAX
  package counts the traces in a function's jit cache, the port counts the
  CUDA graphs it has captured: a registered callable exposes
  ``_cache_size()``, and the guard raises :class:`RetraceError` when an
  entry point captured more graphs than its bound -- the
  one-graph-per-engine discipline of the decode tick, enforced at every
  tick rather than by one-off tests.  Callables without ``_cache_size``
  (eager entry points: prefill waves, chunk steps, the insert scatter) are
  skipped at registration, as in the JAX package.
* **A global capture counter** -- ``install()`` starts counting the CUDA
  graphs every engine captures (each engine's decode graph reports its
  capture through :func:`record_capture`), the counterpart of the JAX
  package's ``backend_compile`` event counter, for workload-level
  assertions (:func:`global_compile_count`).  The JAX ``install()`` also
  turns on ``jax_check_tracer_leaks``; nothing is traced here, so nothing
  can leak from a trace, and that half has no counterpart.

``install()`` is idempotent and cheap.  Enable the per-tick guard for a
run with ``REPRO_SANITIZE=1``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

__all__ = [
    "CompileGuard",
    "RetraceError",
    "enabled",
    "install",
    "installed",
    "global_compile_count",
    "record_capture",
]


def enabled() -> bool:
    """True when ``REPRO_SANITIZE`` is set to a truthy value."""
    return os.environ.get("REPRO_SANITIZE", "").lower() in (
        "1", "true", "yes", "on",
    )


class RetraceError(AssertionError):
    """An entry point captured more graphs than its documented bound."""


# ---------------------------------------------------------------- installer

_installed = False
_global_captures = 0


def install() -> None:
    """Start the global capture counter.  Idempotent; safe to call from
    ``conftest.py`` at collection time."""
    global _installed
    _installed = True


def installed() -> bool:
    return _installed


def record_capture() -> None:
    """Count one CUDA-graph capture (an engine's decode graph calls this
    after each capture); counted only once :func:`install` has run."""
    global _global_captures
    if _installed:
        _global_captures += 1


def global_compile_count() -> int:
    """CUDA-graph captures by every engine since :func:`install` (0 if
    never installed)."""
    return _global_captures


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
