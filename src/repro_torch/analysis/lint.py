"""PyTorch serving-hazard linter: AST checks for the bug classes generic
linters don't know about (port of ``repro/analysis/lint.py``).

Rules (ids are what the waiver syntax names):

* ``captured-cond`` -- a Python ``if``/``while`` on a tensor-valued
  expression inside a body that runs under ``torch.cuda.graph`` capture.
  Reading a tensor's value on the host syncs the capturing stream (which
  the capture refuses) or, when the value happens to be ready, bakes one
  branch into the graph that every replay then takes: the counterpart of
  the JAX rule ``traced-cond``.  A body counts as captured when it is
  handed to ``_DecodeGraph(...)`` (the serving engine's decode tick) or
  ``torch.cuda.make_graphed_callables(...)``, or called inside a ``with
  torch.cuda.graph(...)`` block, anywhere in the same module.  A test is
  tensor-valued when it calls into ``torch`` or a tensor method
  (``TENSOR_METHODS``) or reads a name the body bound from one.  ``is
  None`` / ``isinstance`` / ``hasattr``-style static tests are exempt.
* ``host-sync`` -- a device-to-host synchronization inside a serving
  tick-loop hot path (``HOT_PATHS``): ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``, or ``bool()`` /
  ``int()`` / ``float()`` of a tensor.  Each one stalls the host until the
  card has drained, once per tick: the counterpart of the JAX rule
  ``host-jnp``.  The tick must read its sampled tokens back somewhere;
  such a read carries a reviewed waiver with its reason.
* ``mutable-default`` -- a mutable literal (list/dict/set) default
  argument: shared across calls, a classic aliasing bug.
* ``broad-except`` -- a bare ``except:`` or ``except Exception``/
  ``except BaseException`` that does not re-``raise``: swallows
  tracebacks from genuinely broken code.  A raise chained from the
  caught exception (``raise RuntimeError(...) from e``) keeps its
  traceback and counts as a re-raise (the engine's graph capture,
  ``serve/engine.py``, wraps its failure so).

The JAX rule ``static-arg`` has no counterpart: the port has no ``jit``
and so no static arguments.

Waivers: append ``# repro: allow(<rule>[, <rule>...]) <reason>`` to the
flagged line.  A file-level ``# repro: allow-file(<rule>)`` anywhere in
the file waives the rule for the whole file.  Waivers are the escape hatch
for *reviewed* hazards -- the reason is part of the syntax on purpose.

Baseline: ``repro_torch/analysis/lint_baseline.txt`` lists tolerated
findings as ``path::rule::line-hash`` entries.  The committed baseline is
EMPTY -- the port lints clean -- and stays the mechanism by which a future
rule can land before its violations are burned down
(``--update-baseline``).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re
from typing import Iterable, List, Optional, Set

__all__ = [
    "LintFinding",
    "RULES",
    "HOT_PATHS",
    "lint_source",
    "lint_paths",
    "load_baseline",
    "format_baseline",
]

RULES = (
    "captured-cond",
    "host-sync",
    "mutable-default",
    "broad-except",
)

# Serving tick-loop hot paths: per-tick host work here multiplies with
# every decode step served.  Qualified as ClassName.method: the JAX
# package's list, with ``_decode_args`` as the port's ``_upload_tick``
# and the captured tick body ``_tick_body``.
HOT_PATHS = {
    "ServingEngine.step",
    "ServingEngine.run",
    "ServingEngine._admit",
    "ServingEngine._admit_prefill",
    "ServingEngine._admit_replay",
    "ServingEngine._step_chunked",
    "ServingEngine._insert_wave",
    "ServingEngine._upload_tick",
    "ServingEngine._tick_body",
    "ServingEngine._preempt",
    "ServingEngine._ensure_growth",
    "ServingEngine.dispatch_decode",
    "ServingEngine._postprocess",
    # async front end: every method on the per-tick scheduling path
    "ServeFrontend.tick",
    "ServeFrontend.drain",
    "ServeFrontend.serve",
    "ServeFrontend._dispatch",
    "ServeFrontend._land_inflight",
    "ServeFrontend._chain_safe",
    "ServeFrontend._ensure_chain",
    "ServeFrontend._flush_streams",
}
# methods that read a tensor back to the host
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# methods whose receiver or result is a tensor (numpy arrays share the
# reductions, so only captured bodies, where numpy has no place, read them
# as tensors)
TORCH_METHODS = {"item", "cpu", "cuda", "detach", "to"}
TENSOR_METHODS = TORCH_METHODS | {
    "any", "all", "sum", "max", "min", "amax", "amin", "mean", "argmax",
    "argmin", "nonzero", "eq", "ne", "gt", "lt", "ge", "le", "isfinite",
    "isnan", "norm",
}
_CAPTURE_CALLS = ("_DecodeGraph", "torch.cuda.make_graphed_callables",
                  "make_graphed_callables")
_GRAPH_CONTEXTS = ("torch.cuda.graph", "cuda.graph")

_WAIVE_LINE = re.compile(r"#\s*repro:\s*allow\(([^)]*)\)")
_WAIVE_FILE = re.compile(r"#\s*repro:\s*allow-file\(([^)]*)\)")


@dataclasses.dataclass
class LintFinding:
    path: str
    line: int
    rule: str
    message: str
    source_line: str = ""

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def baseline_key(self) -> str:
        digest = hashlib.sha1(
            self.source_line.strip().encode()
        ).hexdigest()[:12]
        return f"{self.path}::{self.rule}::{digest}"


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.graph' for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _callee(node: ast.AST) -> str:
    """The function a reference names: ``f`` or ``self.f`` -> ``f``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


_STATIC_TEST_CALLS = {"isinstance", "hasattr", "callable", "getattr", "len"}


def _static_test(test: ast.AST) -> bool:
    """Tests that are legal host logic even on tensor-adjacent names."""
    if isinstance(test, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return True
    if isinstance(test, ast.Call):
        if _dotted(test.func).split(".")[-1] in _STATIC_TEST_CALLS:
            return True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _static_test(test.operand)
    if isinstance(test, ast.BoolOp):
        return all(_static_test(v) for v in test.values)
    return False


def _torch_call(node: ast.AST, methods: Set[str]) -> bool:
    """``node`` contains a call into ``torch`` or of one of ``methods``."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = _dotted(n.func)
            if name == "torch" or name.startswith("torch."):
                return True
            if isinstance(n.func, ast.Attribute) and n.func.attr in methods:
                return True
    return False


def _captured_function_names(tree: ast.Module) -> Set[str]:
    """Function names run under CUDA-graph capture in this module."""
    targets: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _dotted(node.func) in \
                _CAPTURE_CALLS and node.args:
            targets.add(_callee(node.args[0]))
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and _dotted(item.context_expr.func) in _GRAPH_CONTEXTS
                for item in node.items):
            for stmt in node.body:
                for n in ast.walk(stmt):
                    if isinstance(n, ast.Call):
                        targets.add(_callee(n.func))
    targets.discard("")
    return targets


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[LintFinding] = []
        self.captured_fns: Set[str] = set()
        self.class_stack: List[str] = []
        # qualified name, captured, names bound from tensor expressions
        self.fn_stack: List[tuple] = []

    # ---------------------------------------------------------------- utils
    def add(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 1)
        src = self.lines[line - 1] if line <= len(self.lines) else ""
        if rule == "host-sync" and any(
                f.line == line and f.rule == rule for f in self.findings):
            return                  # int(t.cpu()): one read, one finding
        self.findings.append(
            LintFinding(self.path, line, rule, message, source_line=src)
        )

    def _hot(self) -> Optional[str]:
        if self.fn_stack and self.fn_stack[-1][0] in HOT_PATHS:
            return self.fn_stack[-1][0]
        return None

    # ------------------------------------------------------------ functions
    def _visit_fn(self, node) -> None:
        qual = ".".join(self.class_stack + [node.name]) if self.class_stack \
            else node.name

        # mutable-default
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]
        for d in defaults:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call)
                and _dotted(d.func) in ("list", "dict", "set")
            ):
                self.add(d, "mutable-default",
                         f"mutable default argument in {qual}() is shared "
                         "across calls")

        captured = node.name in self.captured_fns
        self.fn_stack.append((qual, captured, set()))
        self.generic_visit(node)
        self.fn_stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_fn(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def visit_Lambda(self, node):
        self.fn_stack.append(("<lambda>", False, set()))
        self.generic_visit(node)
        self.fn_stack.pop()

    # ------------------------------------------------ rule: captured-cond
    def _tensor_valued(self, node: ast.AST) -> bool:
        if _torch_call(node, TENSOR_METHODS):
            return True
        bound = self.fn_stack[-1][2]
        return any(isinstance(n, ast.Name) and n.id in bound
                   for n in ast.walk(node))

    def visit_Assign(self, node):
        if self.fn_stack and self.fn_stack[-1][1] and \
                self._tensor_valued(node.value):
            for target in node.targets:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        self.fn_stack[-1][2].add(n.id)
        self.generic_visit(node)

    def _check_cond(self, node) -> None:
        if not self.fn_stack:
            return
        qual, captured, _ = self.fn_stack[-1]
        if not captured or _static_test(node.test):
            return
        if self._tensor_valued(node.test):
            kind = "while" if isinstance(node, ast.While) else "if"
            self.add(node, "captured-cond",
                     f"Python `{kind}` on a tensor inside {qual}, which runs "
                     "under CUDA-graph capture -- the host read syncs the "
                     "capture or bakes one branch into every replay (use "
                     "torch.where, or decide on host values before the "
                     "tick)")

    def visit_If(self, node):
        self._check_cond(node)
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_cond(node)
        self.generic_visit(node)

    # ---------------------------------------------------- rule: host-sync
    def visit_Call(self, node):
        hot = self._hot()
        if hot is not None:
            fn = _dotted(node.func)
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in SYNC_METHODS:
                self.add(node, "host-sync",
                         f".{node.func.attr}() in serving hot path {hot} "
                         "reads a tensor back and stalls the host every "
                         "tick")
            elif fn in ("torch.cuda.synchronize", "cuda.synchronize"):
                self.add(node, "host-sync",
                         f"{fn}() in serving hot path {hot} drains the "
                         "card every tick")
            elif fn in ("bool", "int", "float") and node.args and \
                    _torch_call(node.args[0], TORCH_METHODS):
                self.add(node, "host-sync",
                         f"{fn}() of a tensor in serving hot path {hot} "
                         "reads it back and stalls the host every tick")
        self.generic_visit(node)

    # -------------------------------------------------- rule: broad-except
    def visit_ExceptHandler(self, node):
        broad = node.type is None or (
            isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException")
        )
        if broad:
            # a bare ``raise``, or a raise chained from the caught
            # exception (``raise X from e``: its traceback is kept)
            reraises = any(
                isinstance(n, ast.Raise) and (
                    n.exc is None
                    or (node.name is not None
                        and isinstance(n.cause, ast.Name)
                        and n.cause.id == node.name))
                for n in ast.walk(node)
            )
            if not reraises:
                what = "bare except" if node.type is None else \
                    f"except {node.type.id}"
                self.add(node, "broad-except",
                         f"{what} swallows unrelated failures -- catch the "
                         "specific exceptions and log what was suppressed")
        self.generic_visit(node)


def _waived_rules_for_line(lines: List[str], lineno: int) -> Set[str]:
    """Waivers on the flagged line."""
    if not (1 <= lineno <= len(lines)):
        return set()
    m = _WAIVE_LINE.search(lines[lineno - 1])
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


def lint_source(source: str, path: str = "<string>") -> List[LintFinding]:
    """Lint one module's source; waivers already applied."""
    tree = ast.parse(source)
    linter = _Linter(path, source)
    linter.captured_fns = _captured_function_names(tree)
    linter.visit(tree)

    lines = source.splitlines()
    file_waived: Set[str] = set()
    for line in lines:
        m = _WAIVE_FILE.search(line)
        if m:
            file_waived |= {r.strip() for r in m.group(1).split(",")}

    kept = []
    for f in linter.findings:
        if f.rule in file_waived:
            continue
        if f.rule in _waived_rules_for_line(lines, f.line):
            continue
        kept.append(f)
    return kept


def iter_py_files(roots: Iterable[str]) -> List[str]:
    out = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            out += [
                os.path.join(dirpath, f)
                for f in filenames if f.endswith(".py")
            ]
    return sorted(out)


def lint_paths(
    roots: Iterable[str],
    baseline: Optional[Set[str]] = None,
) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for path in iter_py_files(roots):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            file_findings = lint_source(source, path)
        except SyntaxError as e:
            findings.append(LintFinding(path, e.lineno or 1, "broad-except",
                                        f"unparseable file: {e.msg}"))
            continue
        findings += file_findings
    if baseline:
        findings = [
            f for f in findings if f.baseline_key() not in baseline
        ]
    return findings


# ------------------------------------------------------------- baseline IO

def baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "lint_baseline.txt")


def load_baseline(path: Optional[str] = None) -> Set[str]:
    path = path or baseline_path()
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        return {
            line.strip() for line in f
            if line.strip() and not line.startswith("#")
        }


def format_baseline(findings: Iterable[LintFinding]) -> str:
    header = (
        "# repro_torch.analysis lint baseline -- tolerated findings, one\n"
        "# `path::rule::line-hash` per line.  Kept EMPTY on main: new\n"
        "# rules land by burning their violations down, not baselining\n"
        "# them.  Regenerate with `python -m repro_torch.analysis --lint "
        "--update-baseline`.\n"
    )
    keys = sorted({f.baseline_key() for f in findings})
    return header + "".join(k + "\n" for k in keys)
