"""Correctness tooling of the port (port of ``repro/analysis``): the
serving engine's capture guard (:mod:`repro_torch.analysis.sanitize`).
The JAX package's kernel-contract checker and lint have no counterpart
yet."""

from repro_torch.analysis.sanitize import CompileGuard, RetraceError, enabled

__all__ = ["CompileGuard", "RetraceError", "enabled"]
