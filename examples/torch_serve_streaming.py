"""Streaming, SLA-scheduled serving through the port's front end.

    PYTHONPATH=src python examples/torch_serve_streaming.py [--device cpu]
        [--asyncio]

The same steps as ``examples/serve_streaming.py`` on the JAX package: a
SMOKE transformer behind ``ServeFrontend`` serves an open-loop Poisson
arrival schedule of two latency classes (``interactive``: 250 ms TTFT
target, ``batch``: 2.5 s), streaming token by token.

* The front end runs in a worker thread (``fe.drain()``) and dispatches
  double-buffered decode ticks: on the card each tick is one replay of
  the engine's captured CUDA graph, and tick N+1 takes tick N's sampled
  tokens on the device before tick N's tokens reach the host
  (``fe.stats["chained"]`` counts those dispatches).
* Each ``submit()`` returns a ``TokenStream``; the main thread consumes
  them as tokens land and prints each request's TTFT and token gaps.
* Admission is earliest-deadline-first across the class queues, and the
  outputs equal the closed-loop engine's token for token (asserted).
* The engine's gauges (TTFT and tick percentiles, peak queue depth per
  class) sum the run up.

``--asyncio`` serves the same schedule on an asyncio event loop
(``await fe.serve()`` and ``async for tok in stream``).  Runs on the card
by default; ``--device cpu`` runs the plain versions.
"""

import argparse
import asyncio
import threading
import time

import numpy as np

from repro_torch.configs import get_smoke
from repro_torch.models import build_model
from repro_torch.serve import (
    Request, ServeFrontend, ServingEngine, poisson_arrivals,
)

PROMPTS = [[3, 141, 59], [26, 5], [35, 89, 79, 32], [38, 46],
           [2, 7, 18], [91, 14, 5, 5], [60, 61], [7] * 9]
MAX_NEW = 8


def _requests(now: float):
    arrivals = poisson_arrivals(np.random.default_rng(0), 40.0,
                                len(PROMPTS), start=now + 0.05)
    return [
        Request(uid=i, prompt=list(p), max_new_tokens=MAX_NEW,
                arrival_time=float(arrivals[i]),
                latency_class="interactive" if i % 2 == 0 else "batch")
        for i, p in enumerate(PROMPTS)
    ]


def main(device=None, use_asyncio: bool = False):
    model = build_model(get_smoke("qwen2-0.5b"), device=device)
    params = model.init(0)
    kw = dict(n_slots=4, max_len=64, cache="paged", block_size=16,
              device=model.device)

    # closed-loop reference: scheduling never changes greedy outputs
    ref_engine = ServingEngine(model, params, **kw)
    ref_reqs = [Request(uid=i, prompt=list(p), max_new_tokens=MAX_NEW)
                for i, p in enumerate(PROMPTS)]
    for r in ref_reqs:
        ref_engine.submit(r)
    ref_engine.run()
    ref = {r.uid: r.output for r in ref_reqs}

    engine = ServingEngine(model, params, **kw)
    fe = ServeFrontend(engine)
    reqs = _requests(engine.clock())
    streams = [fe.submit(r) for r in reqs]

    if use_asyncio:
        async def consume(stream):
            async for _ in stream:
                pass
            req = stream.request
            print(f"req {req.uid} [{req.latency_class:11s}] done: "
                  f"{stream.tokens}")

        async def run():
            server = asyncio.create_task(fe.serve())
            await asyncio.gather(*(consume(s) for s in streams))
            await server

        asyncio.run(run())
    else:
        worker = threading.Thread(target=fe.drain)
        worker.start()
        for s in streams:
            req = s.request
            for _ in s:                      # tokens land one by one
                pass
            first = s.token_times[0] - req.arrival_time
            gaps = np.diff(s.token_times) * 1e3
            print(f"req {req.uid} [{req.latency_class:11s}] "
                  f"ttft={first * 1e3:6.1f}ms "
                  f"gap_p50={np.percentile(gaps, 50):5.2f}ms "
                  f"tokens={s.tokens}")
        worker.join()

    assert {r.uid: r.output for r in reqs} == ref, \
        "front-end scheduling changed greedy outputs"
    print("all streamed outputs match the closed-loop engine")
    s = engine.stats
    print(f"frontend: {fe.stats['chained']} chained (double-buffered) / "
          f"{fe.stats['host_dispatch']} host dispatches over "
          f"{fe.stats['ticks']} ticks on {model.device}; capture guard "
          f"{engine.compile_guard.counts()}")
    print(f"gauges: ttft_p50={s['ttft_p50'] * 1e3:.1f}ms "
          f"ttft_p99={s['ttft_p99'] * 1e3:.1f}ms "
          f"tick_p50={s['tick_p50'] * 1e6:.0f}us "
          f"qdepth_peak={s.get('queue_depth_peak', {})}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--asyncio", action="store_true",
                    help="drive the front end on an asyncio event loop "
                         "instead of a worker thread")
    args = ap.parse_args()
    t0 = time.perf_counter()
    main(args.device, use_asyncio=args.asyncio)
    print(f"({time.perf_counter() - t0:.1f}s total)")
