"""Chunked prefill in the port, held against the JAX package on the CPU:
``chunk_attention`` and ``Transformer.prefill_chunk`` (logits and staging
cache, several ``pos`` / ``n_valid`` values, a partial last chunk) at
1e-5, and the chunked engine's greedy tokens, chunk steps and decode
ticks equal to the JAX chunked engine's and to the wave engine's, on the
dense cache and on a paged pool (mirroring ``tests/test_paging.py``'s
chunked tests), on the llama2-7b-proxy and qwen2-0.5b SMOKE configs."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest, ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.models import build_model
from repro_torch.models.attention import chunk_attention
from repro_torch.serve import Request, ServingEngine

# the JAX module (its package re-exports functions of other names)
j_attention = importlib.import_module("repro.models.attention")

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["llama2-7b-proxy", "qwen2-0.5b"]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("b,c,h,kv,hd,s,pos", [
    (1, 8, 4, 4, 16, 32, 0),
    (2, 8, 4, 2, 16, 32, 8),         # GQA
    (1, 6, 8, 2, 32, 24, 18),        # the last chunk of a staging buffer
    (2, 4, 2, 1, 8, 16, 3),          # a start off the chunk grid
])
def test_chunk_attention_matches_jax(b, c, h, kv, hd, s, pos, window):
    rs = np.random.RandomState(pos + c)
    q = rs.standard_normal((b, c, h, hd)).astype(np.float32)
    k = rs.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rs.standard_normal((b, s, kv, hd)).astype(np.float32)
    q_pos = pos + np.arange(c, dtype=np.int32)
    want = j_attention.chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        window=window)
    got = chunk_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          torch.from_numpy(q_pos).long(), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The JAX model with perturbed QuanTA, and the port's with the same
    weights."""
    jm = j_build_model(j_get_smoke(arch))
    params = jm.init(jax.random.PRNGKey(0))
    base, peft = j_attach(jax.random.PRNGKey(1), params,
                          JPeftConfig(method="quanta",
                                      n_axes=get_peft(arch).n_axes))
    rs = np.random.RandomState(3)
    peft = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), peft)
    tm = build_model(get_smoke(arch), device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    tpeft = interop.adapter_set_from_numpy(peft, "cpu")
    return jm, base, peft, tm, tbase, tpeft


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax(arch, as_tensor):
    """A 21-token prompt in chunks of 8 (the last one partial, 5 real
    tokens) through a staging cache of 24: each chunk's logits and the
    staging cache after it equal the JAX package's; ``pos`` and
    ``n_valid`` may be ints or tensors."""
    jm, base, peft, tm, tbase, tpeft = _pair(arch)
    c, s_stage = 8, 24
    prompt = np.random.RandomState(5).randint(1, jm.cfg.vocab_size, 21)
    jc = jm.init_cache(1, s_stage)
    tc = tm.init_cache(1, s_stage)
    for pos in range(0, len(prompt), c):
        n_valid = min(c, len(prompt) - pos)
        toks = np.zeros((1, c), np.int32)
        toks[0, :n_valid] = prompt[pos:pos + n_valid]
        lj, jc = jm.prefill_chunk(base, peft, {"tokens": jnp.asarray(toks)},
                                  jc, pos, n_valid)
        p, n = ((torch.tensor(pos), torch.tensor(n_valid)) if as_tensor
                else (pos, n_valid))
        lt, tc = tm.prefill_chunk(tbase, tpeft,
                                  {"tokens": torch.from_numpy(toks)}, tc, p,
                                  n)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)
        assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
        assert tc["len"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_equals_full_prefill(arch):
    """The staged prompt's last logits equal one full prefill's."""
    _, _, _, tm, tbase, tpeft = _pair(arch)
    prompt = np.random.RandomState(6).randint(1, tm.cfg.vocab_size, 19)
    full, _ = tm.prefill(tbase, tpeft,
                         {"tokens": torch.from_numpy(prompt[None])})
    c = 8
    tc = tm.init_cache(1, 24)
    for pos in range(0, 19, c):
        n_valid = min(c, 19 - pos)
        toks = np.zeros((1, c), np.int64)
        toks[0, :n_valid] = prompt[pos:pos + n_valid]
        logits, tc = tm.prefill_chunk(tbase, tpeft,
                                      {"tokens": torch.from_numpy(toks)}, tc,
                                      pos, n_valid)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **TOL)


# ---------------------------------------------------------------- engines
PROMPTS = [[3, 141, 59] * 9, [26, 5], [35, 89, 79, 32] * 6, [38, 46],
           [2, 7, 18] * 5, [9] * 11]
# (engine options, max_new): the dense cache; a paged pool that holds the
# batch; a pool too small for it (the batch preempts)
ENGINES = {
    "dense": dict(),
    "paged": dict(cache="paged", block_size=8),
    "paged tight": dict(cache="paged", block_size=4, n_blocks=16),
}


@functools.lru_cache(maxsize=None)
def _jax_engine(arch, case, chunk):
    jm, base, peft, *_ = _pair(arch)
    eng = JEngine(jm, base, peft, n_slots=3, max_len=64, admission="prefill",
                  prefill_chunk=chunk, **ENGINES[case])
    reqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    stats = {k: eng.stats.get(k, 0) for k in ("chunk_calls", "decode_calls",
                                               "prefill_calls",
                                               "preemptions")}
    return [r.output for r in reqs], stats


def _port_engine(arch, case, chunk, backend="reference"):
    _, _, _, tm, tbase, tpeft = _pair(arch)
    if backend != "reference":
        tm = build_model(tm.cfg.replace(attn_backend=backend,
                                        peft_backend=backend), device="cpu")
    eng = ServingEngine(tm, tbase, tpeft, n_slots=3, max_len=64,
                        prefill_chunk=chunk, device="cpu", **ENGINES[case])
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.output) == 8 for r in reqs)
    assert eng._chunking is None
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("case", list(ENGINES))
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_engine_matches_jax_and_the_wave_engine(arch, case):
    """Chunks of 8 through the closed loop: the port's tokens, chunk
    steps, decode ticks, waves and preemptions equal the JAX chunked
    engine's, and its tokens equal the wave engine's."""
    want, j_stats = _jax_engine(arch, case, 8)
    got, eng = _port_engine(arch, case, 8)
    assert got == want
    for key, n in j_stats.items():
        assert eng.stats[key] == n, key
    assert eng.stats["chunk_calls"] > 0
    if case == "paged tight":
        assert eng.stats["preemptions"] > 0
    wave, _ = _port_engine(arch, case, None)
    assert wave == got
    if eng.pager is not None:
        assert eng.stats["blocks_in_use"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_engine_kernel_backend_matches(arch):
    """The kernel backends (their plain versions on the CPU) chunk the
    same tokens."""
    want, _ = _jax_engine(arch, "paged", 8)
    got, _ = _port_engine(arch, "paged", 8, backend="pallas")
    assert got == want


def test_chunked_admission_interleaves_decode():
    """A long prompt admitted in chunks while a short request decodes:
    the decode tick keeps running between chunks, and both outputs equal
    the wave engine's and the JAX engine's (``tests/test_paging.py``'s
    interleave test)."""
    arch = "qwen2-0.5b"
    jm, base, peft, tm, tbase, tpeft = _pair(arch)
    long_prompt = [int(t) for t in
                   np.random.default_rng(0).integers(1, 255, (40,))]
    outs = {}
    for impl, chunk in (("jax", 8), ("port", 8), ("port", None)):
        if impl == "jax":
            eng = JEngine(jm, base, peft, n_slots=2, max_len=64,
                          cache="paged", block_size=8, prefill_chunk=chunk)
            make = JRequest
        else:
            eng = ServingEngine(tm, tbase, tpeft, n_slots=2, max_len=64,
                                cache="paged", block_size=8,
                                prefill_chunk=chunk, device="cpu")
            make = Request
        short = make(uid=0, prompt=[3, 1, 4], max_new_tokens=20)
        long = make(uid=1, prompt=list(long_prompt), max_new_tokens=6)
        eng.submit(short)
        eng.step()
        before = eng.stats["decode_calls"]
        eng.submit(long)
        eng.run()
        outs[(impl, chunk)] = (short.output, long.output)
        if chunk is not None:
            assert eng.stats["chunk_calls"] == 5
            assert eng.stats["decode_calls"] - before >= 5
    assert outs[("port", 8)] == outs[("jax", 8)] == outs[("port", None)]


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_chunked_staging_is_chunk_aligned(cache):
    """31 tokens in chunks of 6 (bucket 16): the staging cache is
    chunk-aligned, so the last slab cannot clamp over earlier rows, and
    the tokens equal one-shot prefill's (``tests/test_paging.py``'s
    regression)."""
    _, _, _, tm, tbase, tpeft = _pair("qwen2-0.5b")
    prompt = [int(t) for t in
              np.random.default_rng(2).integers(1, 255, (31,))]
    outs = {}
    for chunk in (None, 6):
        eng = ServingEngine(tm, tbase, tpeft, n_slots=1, max_len=40,
                            cache=cache, block_size=8, prefill_chunk=chunk,
                            device="cpu")
        r = Request(uid=0, prompt=list(prompt), max_new_tokens=5)
        eng.submit(r)
        eng.step()
        if chunk is not None:
            staged = eng._chunking["staged"]["k"].shape[2]
            assert staged % chunk == 0 and staged >= len(prompt)
        eng.run()
        outs[chunk] = r.output
    assert outs[6] == outs[None]


def test_chunked_engine_validation_and_reserved_slot():
    """``prefill_chunk`` must be positive; the slot of the admission in
    flight is not free for a wave."""
    _, _, _, tm, tbase, _ = _pair("qwen2-0.5b")
    with pytest.raises(ValueError, match="positive"):
        ServingEngine(tm, tbase, n_slots=2, max_len=64, prefill_chunk=0,
                      device="cpu")
    eng = ServingEngine(tm, tbase, n_slots=2, max_len=64, prefill_chunk=4,
                        device="cpu")
    eng.submit(Request(uid=0, prompt=list(range(1, 12)), max_new_tokens=3))
    eng._admit(chunk=False)
    assert eng._chunking is not None
    assert eng._chunking["slot"] not in eng._free_slots()
    assert eng.stats["chunk_calls"] == 0      # chunk=False: no step yet
