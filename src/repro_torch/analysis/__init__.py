"""Static analysis and sanitizer tooling of the port (port of
``repro/analysis``).

Three parts, one CLI (``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.kernels` -- the kernel-contract checker: each
  CUDA entry point's calls are recorded at the ``ctypes`` boundary as the
  real wrappers make them, and a model of each launcher's geometry
  (:mod:`repro_torch.analysis.geometry`) is checked for in-bounds tiles
  and gathers, exactly-once output coverage, shared memory against the
  block's limit and the wrappers' budgets, and the dtype contract, with
  no card needed; on the card the launchers' ``*_describe`` exports and a
  sentinel run hold the model to the C++.
* :mod:`repro_torch.analysis.lint` -- the serving-hazard linter: AST rules
  for tensor conditionals under CUDA-graph capture, host syncs in the
  tick loop, mutable defaults and broad excepts, with per-line waivers
  and a committed-clean baseline.
* :mod:`repro_torch.analysis.sanitize` -- the ``REPRO_SANITIZE=1``
  capture guard of the serving engine and the global capture counter.
"""

from repro_torch.analysis.kernels import (
    Finding, check_kernels, register_kernel, registered_kernels,
)
from repro_torch.analysis.lint import LintFinding, lint_paths, lint_source
from repro_torch.analysis.sanitize import (
    CompileGuard, RetraceError, enabled, global_compile_count, install,
    installed,
)

__all__ = ["Finding", "check_kernels", "register_kernel",
           "registered_kernels", "LintFinding", "lint_paths", "lint_source",
           "CompileGuard", "RetraceError", "enabled", "install", "installed",
           "global_compile_count"]
