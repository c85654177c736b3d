"""The decode tick over static buffers (the body a CUDA engine captures as
a graph), on the CPU: it gives the tokens of a plain eager dispatch (the
engine's dispatch before the graph, fresh tensors every tick) on the
dense cache, a paged pool that preempts, NF4 KV codes, a bank and an
evicting adapter pool; the capture guard's counts, bounds and
``RetraceError``; a cache leaf that moves raises; and the repairs the
graph needed (RoPE tables with no host copy, the ``len`` leaf and the
block tables kept in place) change no number."""

import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitize
from repro_torch.configs import get_smoke
from repro_torch.core.bank import AdapterBank
from repro_torch.core.peft import PeftConfig, attach
from repro_torch.models import build_model
from repro_torch.models.common import make_rope, merge_cache_slots
from repro_torch.serve import (
    AdapterPool, AdapterStore, Request, ServingEngine,
)
from repro_torch.serve import engine as engine_mod

PROMPTS = [[3, 141, 59] * 3, [26, 5], [35, 89, 79, 32] * 4, [38, 46],
           [2, 7, 18]]


class _PlainDispatch(ServingEngine):
    """The engine with a plain eager dispatch: fresh device tensors for
    tokens, ids and tables at every tick, the decode step, the merge."""

    def dispatch_decode(self, toks, active, fresh=None):
        assert fresh is None
        before = self.cache["len"].clone()
        logits, new = self.model.decode_step(
            self.params, self.peft, self.cache,
            {"tokens": torch.from_numpy(
                np.asarray(toks, np.int64).reshape(-1, 1))},
            block_tables=(torch.from_numpy(self.pager.host_tables())
                          if self._paged else None),
            adapter_ids=self._device_ids(self._adapter_ids),
        )
        self.cache = merge_cache_slots(self.serve_spec, new,
                                       dict(new, len=before), active,
                                       skip_paged=self._paged)
        self._landing = engine_mod._Landing(self._sample(logits))
        self.stats["decode_calls"] += 1
        self._fresh[:] = False
        return logits


def _model(**cfg_kw):
    cfg = get_smoke("llama2-7b-proxy").replace(**cfg_kw)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    base, peft = attach(1, params, PeftConfig(n_axes=4, noise_scale=0.3),
                        device="cpu")
    return model, params, base, peft


def _serve(cls, model, params, peft=None, tenants=None, **kw):
    eng = cls(model, params, peft, n_slots=3, max_len=64, device="cpu", **kw)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    for i, r in enumerate(reqs):
        eng.submit(r, adapter=tenants[i] if tenants else None)
    eng.run()
    assert all(r.done and len(r.output) == 8 for r in reqs)
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("case", [
    "dense", "paged tight", "nf4 KV", "nf4 base", "chunked", "replay",
])
def test_static_buffer_tick_gives_the_plain_dispatch_tokens(case):
    cfg_kw, kw = {}, {}
    if case == "paged tight":
        kw = dict(cache="paged", block_size=4, n_blocks=12)
    elif case == "nf4 KV":
        cfg_kw = dict(kv_quant="nf4")
        kw = dict(cache="paged", block_size=8, kv_quant="nf4")
    elif case == "nf4 base":
        kw = dict(cache="paged", block_size=8, base_quant="nf4")
    elif case == "chunked":
        kw = dict(prefill_chunk=4)
    elif case == "replay":
        kw = dict(admission="replay")
    model, _, base, peft = _model(**cfg_kw)
    want, _ = _serve(_PlainDispatch, model, base, peft, **kw)
    got, eng = _serve(ServingEngine, model, base, peft, **kw)
    assert got == want
    if case == "paged tight":
        assert eng.stats["preemptions"] > 0
    # a CPU engine captures nothing, so it registers no entry point
    assert eng.compile_guard.entry_points == []
    assert eng.compilation_bounds() == {"decode": 1}


def test_static_buffer_tick_with_a_bank_and_a_pool():
    """A bank of a QuanTA and two LoRA tenants mixed per request, and the
    same tenants through a pool of one row per group (it evicts and
    reloads between ticks, in place): the plain dispatch's tokens."""
    model, params, qbase, qset = _model()
    tenants = {"Q": (qbase, qset)}
    for seed, name in ((5, "La"), (6, "Lb")):
        _, lset = attach(seed, params, PeftConfig(method="lora", rank=4),
                         device="cpu")
        gen = torch.Generator().manual_seed(seed)
        for a in lset.flat().values():
            a.b.add_(0.1 * torch.randn(a.b.shape, generator=gen))
        tenants[name] = lset
    mix = ["Q", "La", "Lb", None, "La"]
    bank = AdapterBank.build(params, tenants)
    want, _ = _serve(_PlainDispatch, model, params, adapters=bank,
                     tenants=mix)
    got, _ = _serve(ServingEngine, model, params, adapters=bank, tenants=mix)
    assert got == want
    store = AdapterStore(max_tenants=4)
    for name, entry in tenants.items():
        store.register(name, entry)
    pooled, eng = _serve(ServingEngine, model, params, tenants=mix,
                         adapters=AdapterPool.build(params, store,
                                                    capacity=1))
    assert pooled == want
    assert eng.stats["adapter_evictions"] > 0


class _FakeCaptured:
    """A callable that says how many graphs it captured."""

    def __init__(self):
        self.graphs = 0

    def __call__(self):
        self.graphs += 1

    def _cache_size(self):
        return self.graphs


def test_compile_guard_counts_bounds_and_raises(monkeypatch):
    guard = sanitize.CompileGuard("engine")
    fn = _FakeCaptured()
    guard.register("decode", fn, 1)
    guard.register("eager", lambda: None, 1)          # skipped
    guard.register("absent", None, 1)                 # skipped
    assert guard.entry_points == ["decode"]
    assert guard.counts() == {"decode": 0}
    assert guard.bounds() == {"decode": 1}
    fn()
    guard.assert_ok()
    assert guard.violations() == []
    fn()
    assert guard.counts() == {"decode": 2}
    assert "2 captures exceed the documented bound of 1" in (
        guard.violations()[0])
    with pytest.raises(sanitize.RetraceError, match="engine.decode"):
        guard.assert_ok()
    assert issubclass(sanitize.RetraceError, AssertionError)
    for value, on in (("1", True), ("yes", True), ("0", False), ("", False)):
        monkeypatch.setenv("REPRO_SANITIZE", value)
        assert sanitize.enabled() is on


def test_step_asserts_the_guard_under_sanitize(monkeypatch):
    """``step()`` asserts the guard every tick under ``REPRO_SANITIZE``."""
    model, params, _, _ = _model()
    eng = ServingEngine(model, params, n_slots=2, max_len=32, device="cpu")
    fn = _FakeCaptured()
    eng.compile_guard.register("decode", fn, 1)
    fn()
    fn()
    eng.submit(Request(uid=0, prompt=[3, 4], max_new_tokens=4))
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    eng.step()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with pytest.raises(sanitize.RetraceError):
        eng.step()


@pytest.mark.parametrize("leaf", ["len", "k"])
def test_a_moved_cache_leaf_raises(leaf):
    """The tick checks that every buffer it captured keeps its storage
    (on the CPU as well, where the same check runs)."""
    model, params, _, _ = _model()
    eng = ServingEngine(model, params, n_slots=2, max_len=32, device="cpu")
    eng.submit(Request(uid=0, prompt=[3, 4, 5], max_new_tokens=8))
    eng.step()
    eng.step()
    eng.cache[leaf] = eng.cache[leaf].clone()
    with pytest.raises(RuntimeError, match="moved since the graph"):
        eng.step()


def test_cache_and_table_buffers_keep_their_storage():
    """Admissions, ticks, preemptions and frees edit the cache and the
    tables in place: no buffer the tick reads ever moves."""
    model, _, base, peft = _model()
    eng = ServingEngine(model, base, peft, n_slots=3, max_len=64,
                        cache="paged", block_size=4, n_blocks=12,
                        device="cpu")
    ptrs = {k: t.data_ptr() for k, t in eng._tick_buffers().items()}
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=8))
    eng.run()
    assert eng.stats["preemptions"] > 0
    assert {k: t.data_ptr() for k, t in eng._tick_buffers().items()} == ptrs


@pytest.mark.parametrize("theta", [10000.0, 1e6, 5e5])
@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_rope_tables_equal_the_tensor_base_form(theta, head_dim):
    """``make_rope`` with a Python-scalar base (no host-to-device copy)
    gives the bits of the earlier tensor-base form."""
    pos = torch.arange(0, 700, 7)[None, :]
    cos, sin = make_rope(pos, head_dim, theta)
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    angles = pos.float()[..., None] * freqs
    assert torch.equal(cos, torch.cos(angles))
    assert torch.equal(sin, torch.sin(angles))


def test_decode_step_advances_len_in_place():
    """``decode_step`` advances ``len`` in the cache's own tensor, and the
    merge restores inactive slots in place: the values of a fresh-tensor
    ``len + 1`` and ``where(active, new, old)``."""
    model, params, _, _ = _model()
    cache = model.init_cache(3, 16)
    cache["len"].copy_(torch.tensor([4, 0, 7], dtype=torch.int32))
    ptr = cache["len"].data_ptr()
    before = cache["len"].clone()
    _, new = model.decode_step(params, None, cache,
                               {"tokens": torch.tensor([[5], [6], [7]])})
    assert new["len"].data_ptr() == ptr
    assert new["len"].tolist() == [5, 1, 8]
    out = merge_cache_slots(model.cache_spec(), new,
                            dict(new, len=before),
                            np.array([True, False, True]))
    assert out["len"].data_ptr() == ptr and out["k"] is cache["k"]
    assert out["len"].tolist() == [5, 0, 8]
