"""The port's streaming front end (``repro_torch.serve.ServeFrontend``)
held against the JAX package's on a ``VirtualClock`` (mirroring
``tests/test_frontend.py``): seeded Poisson arrivals in two latency
classes give the same token streams, TTFT stamps, chained and host
dispatches, tick count and queue-depth peaks, on the dense cache, on a
paged pool (one that preempts through the SLA victim hook too), with
chunked prefill and over a multi-tenant bank; each stream equals the
closed loop's tokens.  Then streaming from a worker thread and through
asyncio, and the front end's validation."""

import asyncio
import functools
import threading

import jax
import numpy as np
import pytest

from repro.configs import get_smoke as j_get_smoke
from repro.core.bank import AdapterBank as JBank
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro.serve import (
    Request as JRequest, ServeFrontend as JFrontend, ServingEngine as JEngine,
    VirtualClock as JClock, poisson_arrivals as j_poisson,
)
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.core.bank import AdapterBank
from repro_torch.models import build_model
from repro_torch.serve import (
    Request, ServeFrontend, ServingEngine, VirtualClock, poisson_arrivals,
)

PROMPTS = [[5, 9, 13], [40, 2], [7, 7, 7, 7, 21, 3, 99], [100, 101],
           [1], [13, 5, 88, 4, 2], [250, 3, 17], [9] * 11]
LONG = [[3] * 40, [5, 9, 13], [7] * 33, [40, 2], [9] * 21]
# two of these fill a pool of 6 blocks of 4 tokens, which then runs dry
TIGHT = [[3] * 10, [7] * 10, [5] * 10, [9] * 6, [2, 4]]
MAX_NEW = 5
ARCH = "qwen2-0.5b"
# case -> (prompts, engine options, virtual seconds a tick or None for
# the front end's own drain, arrival rate)
CASES = {
    "dense": (PROMPTS, {}, None, 200.0),
    "paged": (PROMPTS, dict(cache="paged", block_size=8), None, 200.0),
    "paged, clock moves": (PROMPTS, dict(cache="paged", block_size=8),
                           0.004, 200.0),
    "paged tight": (TIGHT, dict(cache="paged", block_size=4, n_blocks=7),
                    0.004, 400.0),
    "chunked": (LONG, dict(prefill_chunk=8), 0.004, 200.0),
    "chunked, paged": (LONG, dict(prefill_chunk=8, cache="paged",
                                  block_size=8), 0.004, 200.0),
}


@functools.lru_cache(maxsize=None)
def _weights():
    jm = j_build_model(j_get_smoke(ARCH))
    params = jm.init(jax.random.PRNGKey(0))
    qbase, qset = j_attach(jax.random.PRNGKey(1), params,
                           JPeftConfig(method="quanta", n_axes=3,
                                       noise_scale=0.3))
    _, lset = j_attach(jax.random.PRNGKey(2), params,
                       JPeftConfig(method="lora", rank=4))
    lset = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(8), x.shape,
                                              x.dtype), lset)
    return jm, params, qbase, qset, lset


def _torch(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _engines(bank, **kw):
    """The JAX engine and the port's, same weights and options."""
    jm, params, qbase, qset, lset = _weights()
    tm = build_model(get_smoke(ARCH), device="cpu")
    if not bank:
        return (JEngine(jm, params, n_slots=3, max_len=64, **kw),
                ServingEngine(tm, _torch(params), n_slots=3, max_len=64,
                              device="cpu", **kw))
    jb = JBank.build(params, {"qa": (qbase, qset), "lo": lset})
    tb = AdapterBank.build(_torch(params), {
        "qa": (_torch(qbase), interop.adapter_set_from_numpy(qset, "cpu")),
        "lo": interop.adapter_set_from_numpy(lset, "cpu")})
    return (JEngine(jm, params, adapters=jb, n_slots=3, max_len=64, **kw),
            ServingEngine(tm, _torch(params), adapters=tb, n_slots=3,
                          max_len=64, device="cpu", **kw))


def _requests(make, prompts, arrivals=None, tenants=None):
    return [make(uid=i, prompt=list(p), max_new_tokens=MAX_NEW,
                 arrival_time=(float(arrivals[i]) if arrivals is not None
                               else None),
                 latency_class="interactive" if i % 2 == 0 else "batch",
                 adapter=tenants[i % len(tenants)] if tenants else None)
            for i, p in enumerate(prompts)]


def _open_loop(eng, front, clock, poisson, make, prompts, tick_s, rate,
               tenants=None):
    eng.clock = clock
    fe = front(eng)
    arrivals = poisson(np.random.default_rng(0), rate, len(prompts))
    reqs = _requests(make, prompts, arrivals, tenants)
    streams = [fe.submit(r) for r in reqs]
    if tick_s is None:
        fe.drain()
    else:
        while fe.pending():
            if not fe.tick():
                fe._idle()
            clock.advance(tick_s)
        fe.drain()
    assert all(r.done for r in reqs)
    return fe, streams, reqs


def _closed_loop(eng, make, prompts, tenants=None):
    reqs = _requests(make, prompts, tenants=tenants)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.output for r in reqs]


def _summary(fe, streams, reqs):
    eng = fe.engine
    return dict(
        tokens=[s.tokens for s in streams],
        first=[r.first_token_time for r in reqs],
        times=[s.token_times for s in streams],
        stats=dict(fe.stats),
        depth_peak=eng.stats.get("queue_depth_peak"),
        preemptions=eng.stats["preemptions"],
        chunks=eng.stats.get("chunk_calls", 0),
        ttft={c: (h.count, h.percentile(50), h.percentile(99))
              for c, h in sorted(eng.ttft_hists.items())},
    )


@pytest.mark.parametrize("case", list(CASES))
def test_frontend_matches_jax_frontend(case):
    """Same arrivals, same virtual clock: the port's front end makes the
    JAX front end's decisions (streams, stamps, dispatch counts, queue
    peaks), and its streams equal the closed loop's."""
    prompts, kw, tick_s, rate = CASES[case]
    (je, te), (jc, tc) = _engines(False, **kw), _engines(False, **kw)
    want = _summary(*_open_loop(je, JFrontend, JClock(), j_poisson, JRequest,
                                prompts, tick_s, rate))
    got = _summary(*_open_loop(te, ServeFrontend, VirtualClock(),
                               poisson_arrivals, Request, prompts, tick_s,
                               rate))
    assert got == want
    assert got["stats"]["chained"] > 0
    assert got["tokens"] == _closed_loop(tc, Request, prompts)
    assert _closed_loop(jc, JRequest, prompts) == got["tokens"]
    if case == "paged tight":
        assert got["preemptions"] > 0
    if case.startswith("chunked"):
        assert got["chunks"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_frontend_mixed_tenants_matches_jax(paged):
    """EDF scheduling over a bank batch (QuanTA, LoRA and base mixed in
    the same ticks)."""
    kw = dict(cache="paged", block_size=8) if paged else {}
    tenants = ["qa", "lo", None]
    (je, te), (_, tc) = _engines(True, **kw), _engines(True, **kw)
    want = _summary(*_open_loop(je, JFrontend, JClock(), j_poisson, JRequest,
                                PROMPTS, 0.004, 200.0, tenants))
    got = _summary(*_open_loop(te, ServeFrontend, VirtualClock(),
                               poisson_arrivals, Request, PROMPTS, 0.004,
                               200.0, tenants))
    assert got == want and got["stats"]["chained"] > 0
    assert got["tokens"] == _closed_loop(tc, Request, PROMPTS, tenants)


def test_streaming_is_incremental():
    """After the first tick every admitted request has streamed exactly
    its prefill token; blocking iteration then drains each stream."""
    _, eng = _engines(False)
    eng.clock = VirtualClock()
    fe = ServeFrontend(eng)
    streams = [fe.submit(r) for r in _requests(Request, PROMPTS[:3])]
    fe.tick()
    for s in streams:
        assert len(s.tokens) == 1 and not s.done
    fe.drain()
    for s in streams:
        assert s.done and len(s.tokens) == MAX_NEW
        assert list(s) == s.tokens
        assert len(s.token_times) == len(s.tokens)


def test_streams_consume_from_a_worker_thread():
    """The front end drains in a worker thread on the wall clock while
    this thread blocks on the streams."""
    _, eng = _engines(False)
    fe = ServeFrontend(eng)
    reqs = _requests(Request, PROMPTS[:4])
    streams = [fe.submit(r) for r in reqs]
    worker = threading.Thread(target=fe.drain)
    worker.start()
    outs = [s.result() for s in streams]
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert outs == [r.output for r in reqs]
    assert all(len(o) == MAX_NEW for o in outs)
    assert all(r.first_token_time >= r.arrival_time for r in reqs)


def test_async_serve_drains_streams():
    """``serve()`` and ``async for`` interleave on one event loop."""
    _, eng = _engines(False)
    eng.clock = VirtualClock()
    fe = ServeFrontend(eng)
    reqs = _requests(Request, PROMPTS[:3])
    streams = [fe.submit(r) for r in reqs]

    async def consume(stream):
        return [tok async for tok in stream]

    async def main():
        server = asyncio.create_task(fe.serve())
        outs = await asyncio.gather(*(consume(s) for s in streams))
        await server
        return list(outs)

    assert asyncio.run(main()) == [r.output for r in reqs]


def test_preemption_keeps_the_request_and_its_sla_fields():
    """A pool too small for two requests preempts through the SLA victim
    hook; the preempted request requeues as the same object, its arrival
    and class intact, and the outputs equal the dense closed loop's."""
    prompts = [[3] * 10, [7] * 10]
    _, dense = _engines(False)
    ref = _closed_loop(dense, Request, prompts)
    _, eng = _engines(False, cache="paged", block_size=4, n_blocks=7)
    eng.clock = VirtualClock()
    fe = ServeFrontend(eng)
    reqs = _requests(Request, prompts)
    for r in reqs:
        fe.submit(r)
    stamps = [(r.arrival_time, r.latency_class) for r in reqs]
    fe.drain()
    assert eng.stats["preemptions"] > 0
    assert [r.output for r in reqs] == ref
    assert [(r.arrival_time, r.latency_class) for r in reqs] == stamps


def test_frontend_validation():
    tm = build_model(get_smoke(ARCH), device="cpu")
    params = tm.init(0)
    replay = ServingEngine(tm, params, n_slots=2, max_len=64,
                           admission="replay", device="cpu")
    with pytest.raises(ValueError, match="prefill admission"):
        ServeFrontend(replay)
    queued = ServingEngine(tm, params, n_slots=2, max_len=64, device="cpu")
    queued.submit(Request(uid=5, prompt=[1]))
    with pytest.raises(ValueError, match="already has queued"):
        ServeFrontend(queued)
    fe = ServeFrontend(ServingEngine(tm, params, n_slots=2, max_len=64,
                                     device="cpu"))
    fe.submit(Request(uid=0, prompt=[1, 2]))
    with pytest.raises(ValueError, match="already in flight"):
        fe.submit(Request(uid=0, prompt=[3]))
    with pytest.raises(ValueError, match="unknown latency class"):
        fe.submit(Request(uid=1, prompt=[1], latency_class="bulk"))
    assert fe.engine.requeue_hook == fe.scheduler.requeue
    assert fe.engine.victim_hook == fe.scheduler.pick_victim


def test_chained_dispatch_takes_fresh_tokens_from_the_host():
    """The decode tick's token merge: slots marked fresh take the host
    token, the others the previous tick's sampled token on the device (a
    chained tick equals a tick fed those tokens from the host)."""
    _, a = _engines(False)
    _, b = _engines(False)
    for eng in (a, b):
        for i, p in enumerate(PROMPTS[:3]):
            eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=9))
        eng._admit()
    active = np.ones(3, bool)
    a.dispatch_decode(a._last_token, active)
    b.dispatch_decode(b._last_token, active)
    sampled = b._landing.tokens()
    junk = np.full(3, 7, np.int32)
    fresh = np.array([False, True, False])
    host = sampled.copy()
    host[1] = 7
    la = a.dispatch_decode(junk, active, fresh=fresh)
    lb = b.dispatch_decode(host, active)
    assert np.array_equal(la.numpy(), lb.numpy())
    assert not a._fresh.any()
