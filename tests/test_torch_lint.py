"""repro_torch.analysis.lint and .sanitize: the linter must PASS on the
port and FAIL on seeded hazards, and the capture guard must trip (the
counterparts of ``tests/test_analysis.py``'s lint and sanitizer tests).

The rules the two packages share (``mutable-default``, ``broad-except``)
must give the JAX linter's ``(line, rule)`` findings on the same
snippets.
"""

import textwrap

import pytest

import repro_torch
from repro_torch.analysis import lint as pl
from repro_torch.analysis import sanitize

SHARED = ("mutable-default", "broad-except")


def _lint(code):
    return pl.lint_source(textwrap.dedent(code), "seed.py")


# ------------------------------------------------------ the port's rules

def test_captured_cond_in_graph_body_is_caught():
    fs = _lint("""
        import torch

        class Engine:
            def __init__(self):
                self._decode = _DecodeGraph(self._tick_body, None, None)

            def _tick_body(self):
                toks = torch.argmax(self.logits, dim=-1)
                if toks.max() > 2:
                    toks = toks - 1
                return toks
    """)
    assert [f.rule for f in fs] == ["captured-cond"]


def test_captured_while_under_graph_context_is_caught():
    fs = _lint("""
        import torch

        def body(x):
            n = torch.zeros(1)
            while n < x.sum():
                n = n + 1
            return n

        def capture(g, x):
            with torch.cuda.graph(g):
                return body(x)
    """)
    assert [f.rule for f in fs] == ["captured-cond"]
    assert fs[0].line == 6


def test_static_none_test_is_not_flagged():
    fs = _lint("""
        import torch

        def body(x, mask=None):
            if mask is None:
                return torch.relu(x)
            if not isinstance(mask, torch.Tensor):
                return x
            return x * mask

        def capture(g, x):
            with torch.cuda.graph(g):
                body(x)
    """)
    assert fs == []


def test_waiver_suppresses_finding():
    code = """
        import torch

        def body(x):
            if x.sum() > 0:  # repro: allow(captured-cond) x is a host scalar here
                return x
            return -x

        def capture(g, x):
            with torch.cuda.graph(g):
                body(x)
    """
    assert _lint(code) == []
    assert [f.rule for f in _lint(code.replace("# repro: allow",
                                               "# allow"))] == ["captured-cond"]
    assert _lint("# repro: allow-file(captured-cond)\n"
                 + textwrap.dedent(code.replace("# repro: allow", "#"))) == []


def test_mutable_default_and_broad_except_are_caught():
    fs = _lint("""
        def f(x, acc=[]):
            try:
                acc.append(x)
            except Exception:
                pass
            return acc
    """)
    assert sorted(f.rule for f in fs) == ["broad-except", "mutable-default"]


def test_broad_except_with_reraise_is_allowed():
    fs = _lint("""
        def f(x):
            try:
                return x()
            except Exception:
                print("cleanup")
                raise

        def g(x):
            try:
                return x()
            except Exception as e:
                raise RuntimeError("g failed") from e
    """)
    assert fs == []


def test_host_sync_is_caught_in_hot_path_and_allowed_outside():
    code = """
        import torch

        class ServingEngine:
            def step(self):
                toks = torch.argmax(self.logits, dim=-1)
                n = int(self.lengths.max())             # numpy: allowed
                first = int(toks[0].item())
                host = toks.cpu()
                torch.cuda.synchronize()
                return bool(torch.any(toks)), n, first, host

            def report(self):
                return self.logits.cpu().tolist()       # not a hot path
    """
    fs = _lint(code)
    assert [(f.line, f.rule) for f in fs] == [
        (8, "host-sync"), (9, "host-sync"), (10, "host-sync"),
        (11, "host-sync")]
    assert "int() of a tensor" in fs[0].message    # one finding a read
    assert "synchronize" in fs[2].message


def test_static_arg_has_no_counterpart():
    """The port has no ``jit``, so the JAX rule ``static-arg`` has no
    counterpart: the rule set is the JAX set with ``captured-cond`` and
    ``host-sync`` in place of ``traced-cond`` and ``host-jnp``."""
    from repro.analysis import lint as jl

    assert "static-arg" not in pl.RULES
    assert set(jl.RULES) - set(pl.RULES) == {"traced-cond", "static-arg",
                                            "host-jnp"}
    assert set(pl.RULES) - set(jl.RULES) == {"captured-cond", "host-sync"}
    assert _lint("""
        import jax
        g = jax.jit(lambda x: x, donate=[1])
    """) == []


def test_port_lints_clean():
    root = list(repro_torch.__path__)[0]
    assert pl.load_baseline() == set()          # the baseline is empty
    findings = pl.lint_paths([root], baseline=pl.load_baseline())
    assert findings == [], [str(f) for f in findings]


def test_engine_token_reads_carry_reviewed_waivers():
    """The tick loop's two reads of sampled tokens are waived, each with
    its reason; without the waivers they are host-sync findings."""
    import repro_torch.serve.engine as eng

    src = open(eng.__file__, encoding="utf-8").read()
    waived = [line for line in src.splitlines()
              if "repro: allow(host-sync)" in line]
    assert len(waived) == 2
    assert all(len(line.split("allow(host-sync)")[1].strip()) > 20
               for line in waived)
    bare = src.replace("# repro: allow(host-sync)", "#")
    fs = pl.lint_source(bare, "engine.py")
    assert [f.rule for f in fs] == ["host-sync", "host-sync"]


# --------------------------------------------- against the JAX linter

SNIPPETS = [
    """
    def f(x, acc=[], seen={}, *, opts=set()):
        return acc
    """,
    """
    def f(x, acc=list()):
        try:
            acc.append(x)
        except Exception:
            pass
        try:
            x()
        except:
            return None
        try:
            x()
        except BaseException:
            print("cleanup")
            raise
        return acc
    """,
    """
    class C:
        def m(self, cache={}):
            try:
                return cache[1]
            except (KeyError, Exception):
                return None
            except ValueError:
                return 0

        def n(self, xs=(1, 2), d=None):
            return xs
    """,
]


@pytest.mark.parametrize("snippet", SNIPPETS)
def test_shared_rules_match_the_jax_linter(snippet):
    from repro.analysis import lint as jl

    code = textwrap.dedent(snippet)
    want = [(f.line, f.rule) for f in jl.lint_source(code, "s.py")
            if f.rule in SHARED]
    got = [(f.line, f.rule) for f in pl.lint_source(code, "s.py")
           if f.rule in SHARED]
    assert got == want
    assert want


# ------------------------------------------------------ capture sanitizer

class _Captured:
    """A stand-in entry point that captures one graph per new shape."""

    def __init__(self):
        self.shapes = set()

    def __call__(self, shape):
        self.shapes.add(shape)

    def _cache_size(self):
        return len(self.shapes)


def test_compile_guard_trips_on_recapture():
    fn = _Captured()
    guard = sanitize.CompileGuard("seed")
    guard.register("poly", fn, bound=1)
    fn((4,))
    guard.assert_ok()
    assert guard.counts() == {"poly": 1}
    fn((8,))                                  # a second graph
    assert guard.counts() == {"poly": 2}
    with pytest.raises(sanitize.RetraceError, match="poly"):
        guard.assert_ok()
    assert guard.violations()


def test_compile_guard_skips_eager_fns():
    guard = sanitize.CompileGuard("seed")
    guard.register("eager", lambda x: x, bound=1)
    guard.register("none", None, bound=1)
    assert guard.entry_points == []
    guard.assert_ok()


def test_engine_carries_guard_with_documented_bounds():
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    model = build_model(get_smoke("qwen2-0.5b"), device="cpu")
    engine = ServingEngine(model, model.init(0), n_slots=2, max_len=64,
                           device="cpu")
    assert engine.compilation_bounds()["decode"] == 1
    # the CPU runs the tick body eagerly: nothing to capture, nothing
    # registered
    assert engine.compile_guard.entry_points == []
    assert engine._decode._cache_size() == 0


def test_install_starts_the_global_capture_count(monkeypatch):
    monkeypatch.setattr(sanitize, "_installed", False)
    monkeypatch.setattr(sanitize, "_global_captures", 0)
    sanitize.record_capture()                 # not counted before install
    assert not sanitize.installed()
    assert sanitize.global_compile_count() == 0
    sanitize.install()
    sanitize.install()                        # idempotent
    assert sanitize.installed()
    sanitize.record_capture()
    sanitize.record_capture()
    assert sanitize.global_compile_count() == 2
    from repro_torch import analysis

    assert analysis.install is sanitize.install
    assert analysis.global_compile_count is sanitize.global_compile_count
