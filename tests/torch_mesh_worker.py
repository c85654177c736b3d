"""The rank side of ``tests/test_torch_mesh.py``.

The test module pickles a dict of jobs (``name -> (function name,
keyword arguments)``) with ``torch.save``; :func:`spawn` starts one
process a rank (gloo on the CPU, a file store), each rank runs every job
in order and saves its results, and :func:`spawn` returns them as
``{rank: {name: result}}``.  A job that raises on a rank records its
traceback under ``"error"``.  This module imports neither ``jax`` nor the
JAX package, so a rank starts with ``torch`` alone.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

_MESHES = {}
# what a forkserver imports once for every rank it forks
PRELOAD = ["torch_mesh_worker", "torch.distributed.tensor",
           "torch.distributed.device_mesh", "repro_torch.serve",
           "repro_torch.launch", "repro_torch.train", "repro_torch.checkpoint",
           "repro_torch.configs", "repro_torch.models"]


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh

    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh("cpu", tuple(shape),
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


def _rank_main(rank, world, init_file, job_file, out_dir):
    try:
        _run_jobs(rank, world, init_file, job_file, out_dir)
    except BaseException:
        # what ended the rank, for the test's report
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _run_jobs(rank, world, init_file, job_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    jobs = torch.load(job_file, weights_only=False)
    results = {}
    for name, (fn, kw) in jobs.items():
        try:
            results[name] = globals()[fn](**kw)
        except Exception:                              # noqa: BLE001
            results[name] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def errors(out_dir: str) -> str:
    """The tracebacks of the ranks that ended with an exception."""
    return "\n".join(open(os.path.join(out_dir, f)).read()
                     for f in sorted(os.listdir(out_dir))
                     if f.endswith(".err"))


def spawn(world: int, jobs: dict, tmp_dir: str) -> dict:
    """Run ``jobs`` on ``world`` gloo ranks; ``{rank: {name: result}}``."""
    import torch.multiprocessing as mp

    job_file = os.path.join(tmp_dir, "jobs.pt")
    torch.save(jobs, job_file)
    mp.spawn(_rank_main, args=(world, os.path.join(tmp_dir, "store"),
                               job_file, tmp_dir), nprocs=world, join=True)
    return {r: torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(world)}


# ------------------------------------------------------------- serving
def serve(mesh_shape, arch, params, cfg_kw=None, peft=None, bank=None,
          pool=None, engine_kw=None, prompts=(), max_new=5, tenants=None,
          frontend=None, arena_probe=False):
    """One engine run under a ``mesh_shape`` host mesh: the greedy tokens,
    the stats, and this rank's bytes counted from the engine's leaves."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.serve import (
        AdapterPool, AdapterStore, Request, ServingEngine,
    )
    from repro_torch.serve.paging import addressable_nbytes

    t0 = time.monotonic()
    mesh = _mesh(mesh_shape)
    model = build_model(get_smoke(arch).replace(**(cfg_kw or {})),
                        device="cpu")
    adapters = bank
    if pool is not None:
        store = AdapterStore(max_tenants=8)
        for name, entry in pool["tenants"].items():
            store.register(name, entry)
        adapters = AdapterPool.build(params, store,
                                     capacity=pool["capacity"])
    eng = ServingEngine(model, params, peft, adapters=adapters,
                        device="cpu", mesh=mesh, **(engine_kw or {}))
    out = {"data_shards": eng.pager.data_shards if eng.pager else 1,
           "first_bytes": eng.stats["cache_bytes_allocated"],
           "leaf_bytes": {k: addressable_nbytes(v)
                          for k, v in eng.placed_cache.items()},
           "param_bytes": eng.stats["param_bytes"],
           "model_shards": eng.stats["model_shards"],
           "whole_sharded": _whole_sharded(eng, params),
           "per_block": eng.pager._bytes_per_block if eng.pager else 0.0,
           "eager": eng._decode.eager}
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=max_new,
                    latency_class="interactive" if i % 2 == 0 else "batch",
                    adapter=tenants[i % len(tenants)] if tenants else None)
            for i, p in enumerate(prompts)]
    if frontend is not None:
        from repro_torch.serve import (
            ServeFrontend, VirtualClock, poisson_arrivals,
        )

        clock = VirtualClock()
        eng.clock = clock
        fe = ServeFrontend(eng)
        arrivals = poisson_arrivals(np.random.default_rng(0),
                                    frontend["rate"], len(reqs))
        for r, t in zip(reqs, arrivals):
            r.arrival_time = float(t)
        streams = [fe.submit(r) for r in reqs]
        while fe.pending():
            if not fe.tick():
                fe._idle()
            clock.advance(frontend["tick_s"])
        fe.drain()
        out["streams"] = [list(s.tokens) for s in streams]
        out["chained"] = fe.stats["chained"]
    elif arena_probe:
        # a hog fills arena 0; a late request must admit into shard 1
        hog = Request(uid=0, prompt=[7] * 8, max_new_tokens=30)
        quick = [Request(uid=1 + i, prompt=[3 + i] * 8, max_new_tokens=2)
                 for i in range(3)]
        reqs = [hog] + quick
        for r in reqs:
            eng.submit(r)
        eng.run(max_ticks=26)
        out["quick_done"] = all(r.done for r in quick) and not hog.done
        out["arena0_full"] = eng.pager.can_admit(8, 0) is False
        late = Request(uid=9, prompt=[5] * 8, max_new_tokens=4)
        eng.submit(late)
        eng.step()
        out["late_admitted"] = any(r is late for r in eng.slots)
        eng.run()
        out["late_done"] = late.done and hog.done
        reqs = reqs + [late]
    else:
        for r in reqs:
            eng.submit(r)
        eng.run()
    out["tokens"] = [r.output for r in reqs]
    out["done"] = all(r.done for r in reqs)
    out["stats"] = {k: eng.stats[k] for k in (
        "preemptions", "blocks_in_use", "cache_bytes_allocated",
        "prefill_calls", "chunk_calls") if k in eng.stats}
    from repro_torch.models.common import PagedCacheLeafSpec

    out["dense_bytes"] = sum(
        addressable_nbytes(v) for k, v in eng.placed_cache.items()
        if not (eng._paged
                and isinstance(eng.serve_spec[k], PagedCacheLeafSpec)))
    out["seconds"] = time.monotonic() - t0
    if pool is not None:
        out["pins"] = [adapters.pins_of(n) for n in pool["tenants"]]
    return out


def _whole_sharded(eng, params):
    """Paths of the leaves the decode rule shards over `model` that the
    engine holds whole (none under tensor parallelism)."""
    from repro_torch.launch.shardings import map_with_paths, param_shardings

    if eng.stats["model_shards"] == 1:
        return []
    specs = param_shardings(eng.cfg, eng.mesh, params, decode=True)
    held = {}
    map_with_paths(lambda p, t: held.__setitem__("/".join(p), t.shape),
                   eng.params)
    out = []
    map_with_paths(lambda p, t, sp: out.append("/".join(p)) if (
        "model" in sp and held.get("/".join(p)) == t.shape) else None,
        params, specs)
    return out


# ------------------------------------------------ tensor parallelism
class _SkipReduce:
    """A planted fault: this rank's `model` group takes part in every
    ``all_reduce`` but keeps its own partial sum."""

    def __init__(self, tp):
        self.tp = tp
        self.size, self.rank = tp.size, tp.rank

    def __getattr__(self, name):
        return getattr(self.tp, name)

    def all_reduce(self, t):
        self.tp.all_reduce(t.clone())
        return t


def tp_model(mesh_shape, arch, base, peft, tokens, lens, steps, fault=False):
    """``prefill`` and ``decode_step``s of ``arch``'s SMOKE model on this
    rank's shards (``local_params``) under the mesh's `model` group: the
    logits of each call (with ``fault``, rank 0 skips every
    ``all_reduce``)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.shardings import local_params
    from repro_torch.models import build_model
    from repro_torch.models.tensor_parallel import model_group

    mesh = _mesh(mesh_shape)
    model = build_model(get_smoke(arch), device="cpu")
    tp = model_group(mesh)
    if fault and tp.rank == 0:
        tp = _SkipReduce(tp)
    params = local_params(model.cfg, mesh, base)
    logits, wave = model.prefill(params, peft, {"tokens": tokens},
                                 lengths=lens, tp=tp)
    out = [logits]
    cache = model.init_cache(4, 48, tp=tp)
    model.insert_cache(cache, np.array([2, 0, 1]), wave)
    for nxt in steps:
        logits, cache = model.decode_step(params, peft, cache,
                                          {"tokens": nxt}, tp=tp)
        out.append(logits.clone())
    return {"logits": out, "kv_heads": cache["k"].shape[3]}


def tp_leaves(mesh_shape, arch, params):
    """This rank's ``local_params`` of ``params`` (and of them packed NF4
    from the shards, and of the whole params packed NF4 first), its
    `model` coordinate, and whether the same params placed as DTensors by
    the decode specs give the same local leaves."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import mesh_coordinate
    from repro_torch.launch.shardings import (
        distribute_tree, local_params, param_shardings,
    )
    from repro_torch.core.adapters import tree_leaves

    mesh = _mesh(mesh_shape)
    cfg = get_smoke(arch)
    local = local_params(cfg, mesh, params)
    placed = distribute_tree(params, mesh,
                             param_shardings(cfg, mesh, params, decode=True))
    again = local_params(cfg, mesh, placed)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(local),
                                                 tree_leaves(again)))
    from repro_torch.core.quantize import quantize_params

    bs = cfg.quant_block_size
    return {"local": local, "coord": mesh_coordinate(mesh)["model"],
            "dtensor_same": same,
            "nf4": local_params(cfg, mesh, params, base_quant="nf4",
                                block_size=bs),
            "nf4 packed": local_params(cfg, mesh, quantize_params(
                params, "nf4", block_size=bs))}


def tp_refusals(mesh_shape, arch, params, pefts):
    """What a `model` split refuses: KV heads that ``model`` does not
    divide, and each adapter set in ``pefts`` (DoRA, DoTA, KronA)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    mesh = _mesh(mesh_shape)
    out = {}
    odd = build_model(get_smoke(arch).replace(n_kv_heads=1), device="cpu")
    cases = [("kv heads", odd, odd.init(0), None)] + [
        (name, build_model(get_smoke(arch), device="cpu"), params, peft)
        for name, peft in pefts.items()]
    for name, model, p, peft in cases:
        try:
            ServingEngine(model, p, peft, n_slots=4, max_len=64,
                          device="cpu", mesh=mesh)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


# ------------------------------------------------------ the paged decode
def sharded_decode(mesh_shape, q, k_pool, v_pool, tables, lens, kv_quant=None,
                   k_scales=None, v_scales=None, quant_block=64):
    """``paged_decode_attention(mesh=)`` on global inputs that every rank
    holds: this rank's rows of the output, its shard and whether the
    sharded branch ran."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import dp_index
    from repro_torch.models.attention import paged_decode_attention

    mesh = _mesh(mesh_shape)
    out = paged_decode_attention(
        q, k_pool, v_pool, tables, lens, backend="pallas", mesh=mesh,
        kv_quant=kv_quant, k_scales=k_scales, v_scales=v_scales,
        quant_block=quant_block, value_dtype=q.dtype)
    return {"sharded": isinstance(out, DTensor), "shard": dp_index(mesh),
            "local": out.to_local() if isinstance(out, DTensor) else out}


# ------------------------------------------------------------- training
def train_dp(mesh_shape, arch, params, peft, batches, compress,
             microbatches=1):
    """``len(batches)`` data-parallel steps over the mesh's data axis:
    each step's loss and grad norm."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, make_train_step

    mesh = _mesh(mesh_shape)
    model = build_model(get_smoke(arch), device="cpu")
    opt = AdamW(lr=1e-2)
    step = make_train_step(model, opt, microbatches=microbatches,
                           compress=compress, dp_axes=("data",), mesh=mesh)
    state = TrainState.create(params, peft, opt, compress=compress)
    out = []
    for batch in batches:
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def psum(mesh_shape, xs):
    """``compressed_psum`` of this rank's ``xs[data index]``."""
    from repro_torch.launch.mesh import dp_index
    from repro_torch.optim import compressed_psum

    mesh = _mesh(mesh_shape)
    return compressed_psum(xs[dp_index(mesh)], "data", mesh)


# ------------------------------------------------------------- pipeline
def pipeline(n_stages, w, b, x):
    """``pipeline_apply`` of the tanh stack, its outputs and the gradient
    of ``sum(out ** 2)`` this rank's stage holds."""
    from repro_torch.train import pipeline_apply

    mesh = _mesh((n_stages,), ("stage",))
    params = {"w": w.clone().requires_grad_(True),
              "b": b.clone().requires_grad_(True)}

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    out = pipeline_apply(layer_fn, params, x, mesh=mesh)
    (out ** 2).sum().backward()
    return {"out": out.detach(), "w": params["w"].grad,
            "b": params["b"].grad}


# ------------------------------------------------------------- restores
def restore(mesh_shape, directory, step, template, spec_kind, arch):
    """``restore_resharded`` onto the mesh: every leaf's local shard and
    the slice of the whole leaf it should be."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import (
        restore_resharded, tree_flatten_with_paths,
    )
    from repro_torch.configs import get_smoke
    from repro_torch.launch.shardings import (
        P, map_with_paths, param_shardings, state_shardings,
    )

    mesh = _mesh(mesh_shape)
    cfg = get_smoke(arch)
    if spec_kind == "state":
        specs = state_shardings(cfg, mesh, template)
    elif spec_kind == "params":
        specs = param_shardings(cfg, mesh, template)
    else:                                       # leading dims over data
        specs = map_with_paths(
            lambda _, t: P("data") if t.dim() and t.shape[0] % 2 == 0
            else P(), template)
    got = restore_resharded(directory, step, template, mesh, specs)
    paths, leaves = tree_flatten_with_paths(got)
    return {p: (leaf.to_local(), [str(x) for x in leaf.placements])
            if isinstance(leaf, DTensor) else (leaf, None)
            for p, leaf in zip(paths, leaves)}


def refusals(mesh_shape, arch):
    """What the sharded engine refuses: an uneven slot split."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    model = build_model(get_smoke(arch), device="cpu")
    try:
        ServingEngine(model, model.init(0), n_slots=3, max_len=64,
                      device="cpu", mesh=_mesh(mesh_shape))
    except ValueError as e:
        return str(e)
    return None
