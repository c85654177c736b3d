"""The port's mesh over real process groups: gloo ranks on the CPU, one
world for each size (2 and 4), its ranks forked from one server that
imported the rank side once, each running every case of its world
(``tests/torch_mesh_worker.py``), held against the port's single-device
runs and the JAX package's.

* Serving (SMOKE configs, f32): the sharded engine on ``(2, 1)`` and
  ``(1, 2)`` (world 2) and ``(2, 2)`` (world 4) gives the greedy tokens of
  the port's meshless engine and of the JAX single-device engine, on
  every rank: dense, paged, paged NF4 KV, NF4 base, a bank, a churning
  ``AdapterPool``, chunked prefill, a preemption that resumes (two arenas
  of 6 blocks), admission past a full arena and the front end; Griffin
  (paged rings) and Mamba2 against the meshless port engine; and every
  rank's byte gauges count what it holds.  Over a `model` axis of 2 the
  qwen2-0.5b engines run tensor-parallel (each rank its shards of the
  weights and its KV heads); Griffin and Mamba2 keep `model` replicated.
* Tensor parallelism at the model level, ``(1, 2)``: ``prefill`` and
  three ``decode_step``s of the qwen2-0.5b (tied table, q/k/v biases) and
  llama2-7b-proxy (untied head) SMOKE models on each rank's shards, with
  folded QuanTA on q/v and LoRA on o_proj and down_proj, against the JAX
  meshless model at 1e-4; a rank that skips the row-parallel
  ``all_reduce`` is caught; each rank's ``local_params`` against the JAX
  decode specs and the whole leaves (also placed as DTensors, and packed
  NF4); and the refusals (KV heads that `model` does not divide, DoRA,
  DoTA, KronA).
* The paged decode under ``mesh=`` on arena-partitioned pools, each
  rank's rows stacked: the global plain paged decode and the JAX kernel
  in interpret mode, at 2e-5 (f32).
* Training: 3 data-parallel steps on ``(2, 1)``, with and without
  ``compress``: loss and grad norm within 1e-5 of one device;
  ``compressed_psum`` equals the numpy sum of JAX's ``compress_int8``
  round trips.
* The pipeline: ``pipeline_apply`` on 4 stages with the JAX test's layer,
  sizes and tolerances (outputs 2e-5, gradients 5e-4) against the
  sequential stack and JAX's ``pipeline_apply`` on a 1-stage mesh.
* Restores: ``restore_resharded`` onto ``(2, 1)`` and ``(1, 2)``: every
  local shard is its slice of the one-device restore bit for bit, also
  of a checkpoint the JAX store wrote.
"""

import functools
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mesh_worker as W
from repro.checkpoint import store as j_store
from repro.configs import get_smoke as j_get_smoke
from repro.core.bank import AdapterBank as JBank
from repro.core.peft import (
    AdapterSet as JAdapterSet, PeftConfig as JPeftConfig, attach as j_attach,
)
from repro.core.quantize import (
    quantize_kv as j_quantize_kv, quantize_params as j_quantize_params,
)
from repro.launch import mesh as j_mesh
from repro.launch import shardings as j_sh
from repro.models import build_model as j_build_model
from repro.optim.compress import compress_int8 as j_compress_int8
from repro.serve import (
    Request as JRequest, ServeFrontend as JFrontend, ServingEngine as JEngine,
    VirtualClock as JClock, poisson_arrivals as j_poisson,
)
from repro.train.pipeline import pipeline_apply as j_pipeline_apply
from repro_torch import interop
from repro_torch.checkpoint import restore, save, tree_flatten_with_paths
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.adapters import tree_leaves
from repro_torch.core.bank import AdapterBank
from repro_torch.core.peft import PeftConfig, attach
from repro_torch.core.quantize import dequantize, quantize_params
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import make_abstract_mesh
from repro_torch.launch.shardings import (
    local_shape, map_with_paths, param_shardings,
)
from repro_torch.models import build_model
from repro_torch.models.attention import paged_decode_shard
from repro_torch.optim import AdamW
from repro_torch.serve import (
    AdapterPool, AdapterStore, Request, ServeFrontend, ServingEngine,
    VirtualClock, poisson_arrivals,
)
from repro_torch.train import TrainState, make_train_step

j_fa = __import__("importlib").import_module("repro.kernels.flash_attention")

ARCH = "qwen2-0.5b"
PROMPTS = [[5, 9, 13], [40, 2], [7, 7, 7, 7, 21, 3, 99], [100, 101],
           [1], [13, 5, 88, 4, 2], [250, 3, 17], [9] * 11]
LONG = [int(t) for t in np.random.default_rng(0).integers(1, 255, (40,))]
TIGHT = [[7 + i] * 8 for i in range(4)]
MIX = ("qa", "lo", None)
POOL_MIX = ("qa", "l0", "l1", None)
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
PAGED = dict(cache="paged", block_size=8)
# case -> (arch, cfg fields, engine options, prompts, new tokens, tenants)
CASES = {
    "dense": (ARCH, {}, {}, PROMPTS, 5, None),
    "paged": (ARCH, {}, PAGED, PROMPTS, 5, None),
    "paged nf4 kv": (ARCH, dict(kv_quant="nf4"), PAGED, PROMPTS, 5, None),
    "nf4 base": (ARCH, {}, dict(PAGED, base_quant="nf4"), PROMPTS, 5, None),
    "bank": (ARCH, {}, PAGED, PROMPTS, 5, MIX),
    "pool": (ARCH, {}, {}, PROMPTS, 5, POOL_MIX),
    "chunked": (ARCH, {}, dict(PAGED, n_slots=2, prefill_chunk=8), [LONG],
                6, None),
    "preempt": (ARCH, {}, dict(PAGED, n_blocks=12), TIGHT, 24, None),
    "frontend": (ARCH, {}, PAGED, PROMPTS, 5, None),
    "griffin paged": ("recurrentgemma-2b", {}, PAGED, PROMPTS, 5, None),
    "mamba2 dense": ("mamba2-1.3b", {}, {}, PROMPTS, 5, None),
}
FRONTEND = dict(rate=200.0, tick_s=0.004)


def _kw(case):
    return dict(dict(n_slots=4, max_len=64), **CASES[case][2])


# ------------------------------------------------------------ weights
def _zeros_to_torch(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    """The JAX model, weights and tenants, without a compile: the port's
    ``init(0)`` weights as numpy (the two packages' param trees match key
    for key), and tenants of ``eval_shape`` structure filled from numpy
    seeds: a folded-QuanTA pair (its base the shared weights) and two
    LoRA sets of one structure."""
    model = j_build_model(j_get_smoke(arch))
    params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()),
        build_model(get_smoke(arch), device="cpu").init(0),
        is_leaf=lambda t: isinstance(t, torch.Tensor))
    if arch != ARCH:
        return model, params, {}

    def filled(tree, seed):
        rs = np.random.RandomState(seed)
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(0.1 * rs.standard_normal(a.shape), a.dtype),
            tree)

    def shapes(seed, cfg):
        return jax.eval_shape(lambda p: j_attach(
            jax.random.PRNGKey(seed), p, cfg)[1], params)

    tenants = {"qa": (params, filled(shapes(1, JPeftConfig(
        method="quanta", n_axes=3)), 1))}
    lora = shapes(2, JPeftConfig(method="lora", rank=4))
    tenants["l0"] = tenants["lo"] = filled(lora, 10)
    tenants["l1"] = filled(lora, 11)
    return model, params, tenants


@functools.lru_cache(maxsize=None)
def _port_side(arch):
    if arch != ARCH:             # held against the meshless port alone
        return build_model(get_smoke(arch), device="cpu").init(0), {}
    _, params, tenants = _jax_side(arch)
    return (_zeros_to_torch(params),
            {n: interop.tenant_from_numpy(e, "cpu")
             for n, e in tenants.items()})


def _port_bank():
    params, tenants = _port_side(ARCH)
    return AdapterBank.build(params, {n: tenants[n] for n in ("qa", "lo")})


def _requests(make, case):
    _, _, _, prompts, max_new, tenants = CASES[case]
    return [make(uid=i, prompt=list(p), max_new_tokens=max_new,
                 latency_class="interactive" if i % 2 == 0 else "batch",
                 adapter=tenants[i % len(tenants)] if tenants else None)
            for i, p in enumerate(prompts)]


# ------------------------------------------------- single-device runs
def _run(eng, reqs, case):
    if case != "frontend":
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.output for r in reqs]
    clock_cls = JClock if isinstance(eng, JEngine) else VirtualClock
    front = JFrontend if isinstance(eng, JEngine) else ServeFrontend
    poisson = j_poisson if isinstance(eng, JEngine) else poisson_arrivals
    clock = clock_cls()
    eng.clock = clock
    fe = front(eng)
    arrivals = poisson(np.random.default_rng(0), FRONTEND["rate"], len(reqs))
    for r, t in zip(reqs, arrivals):
        r.arrival_time = float(t)
    streams = [fe.submit(r) for r in reqs]
    while fe.pending():
        if not fe.tick():
            fe._idle()
        clock.advance(FRONTEND["tick_s"])
    fe.drain()
    return [list(s.tokens) for s in streams]


# The JAX references share an engine where JAX's own tests hold the tokens
# equal: one dense engine for the dense, paged, front-end, chunked and
# preempted cases (paged = dense, chunked = one whole prefill, a preempted
# stream = the ample pool's, the front end's streams = the closed loop's:
# tests/test_torch_frontend.py holds both packages to that), one bank of
# every tenant for the bank and the pool (a pool's tokens are its
# tenants' bank's).  One engine compiles once for all of its cases.
JAX_SHARED = {"dense": "dense", "paged": "dense", "frontend": "dense",
              "chunked": "dense", "preempt": "dense", "bank": "bank",
              "pool": "bank"}


@functools.lru_cache(maxsize=None)
def _jax_engine(case):
    """The JAX single-device engine of ``case`` (or of its shared kind)."""
    arch, cfg_kw, _, _, _, _ = CASES[case]
    model, params, jt = _jax_side(arch)
    if cfg_kw:
        model = j_build_model(j_get_smoke(arch).replace(**cfg_kw))
    kw = _kw(case)
    if "base_quant" in kw:
        # packed under jit; the engine keeps packed leaves as they are
        params = jax.jit(lambda p: j_quantize_params(
            p, kw["base_quant"], block_size=model.cfg.quant_block_size))(
            params)
    adapters = None
    if case == "bank":
        adapters = JBank.build(params, {n: jt[n] for n in ("qa", "lo", "l0",
                                                           "l1")})
    return JEngine(model, params, adapters=adapters, **kw)


@functools.lru_cache(maxsize=None)
def _jax_tokens(case):
    eng = _jax_engine(JAX_SHARED.get(case, case))
    if case == "frontend":
        case = "paged"
    return _run(eng, _requests(JRequest, case), case)


@functools.lru_cache(maxsize=None)
def _port_tokens(case):
    arch, cfg_kw, _, _, _, _ = CASES[case]
    params, tenants = _port_side(arch)
    model = build_model(get_smoke(arch).replace(**cfg_kw), device="cpu")
    adapters = None
    if case == "bank":
        adapters = _port_bank()
    elif case == "pool":
        adapters = AdapterPool.build(params, _store(tenants), capacity=1)
    eng = ServingEngine(model, params, adapters=adapters, device="cpu",
                        **_kw(case))
    return _run(eng, _requests(Request, case), case)


def _store(tenants):
    store = AdapterStore(max_tenants=8)
    for n in ("qa", "l0", "l1"):
        store.register(n, tenants[n])
    return store


def _serve_job(case, shape):
    arch, cfg_kw, _, prompts, max_new, tenants = CASES[case]
    params, port_tenants = _port_side(arch)
    kw = dict(mesh_shape=shape, arch=arch, params=params, cfg_kw=cfg_kw,
              engine_kw=_kw(case), prompts=prompts, max_new=max_new,
              tenants=tenants)
    if case == "bank":
        kw["bank"] = _port_bank()
    elif case == "pool":
        kw["pool"] = dict(capacity=1, tenants={
            n: port_tenants[n] for n in ("qa", "l0", "l1")})
    elif case == "frontend":
        kw["frontend"] = FRONTEND
    return "serve", kw


# --------------------------------------------- the paged decode inputs
def _arena_inputs(quant, d=2, seed=0):
    """Slots 0-1 in arena 0, 2-3 in arena 1 (arenas of 13 rows, row 0 of
    each the null block), shuffled rows, repeated table tails."""
    rs = np.random.RandomState(seed)
    b, h, kv, hd, bs, n_b = 4, 4, 2, 32, 8, 6
    arena = 13
    lens = np.array([1, 20, 45, 33], np.int32)
    tables = np.zeros((b, n_b), np.int32)
    per = b // d
    for shard in range(d):
        perm = rs.permutation(np.arange(1, arena)) + shard * arena
        used = 0
        for i in range(shard * per, (shard + 1) * per):
            c = -(-lens[i] // bs)
            tables[i, :c] = perm[used:used + c]
            tables[i, c:] = tables[i, c - 1]
            used += c
    q = rs.standard_normal((b, 1, h, hd)).astype(np.float32)
    k = rs.standard_normal((d * arena, bs, kv, hd)).astype(np.float32)
    v = rs.standard_normal((d * arena, bs, kv, hd)).astype(np.float32)
    extra = {}
    if quant is not None:
        (k, ks), (v, vs) = (j_quantize_kv(jnp.asarray(k), quant),
                            j_quantize_kv(jnp.asarray(v), quant))
        k, v = np.array(k), np.array(v)
        extra = dict(kv_quant=quant, k_scales=np.array(ks),
                     v_scales=np.array(vs))
    return q, k, v, tables, lens, extra


@functools.lru_cache(maxsize=None)
def _jax_decode(quant):
    """The JAX paged decode kernel (interpret mode) on the two arenas."""
    q, k, v, t, lens, extra = _arena_inputs(quant)
    return np.asarray(j_fa.paged_flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(t),
        jnp.asarray(lens), interpret=True,
        **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in extra.items()}))


def _torch(extra):
    return {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for n, a in extra.items()}


# ------------------------------------------------------- train inputs
@functools.lru_cache(maxsize=None)
def _train_setup():
    model = build_model(get_smoke(ARCH), device="cpu")
    params = model.init(0)
    base, peft = attach(1, params, PeftConfig(method="quanta", n_axes=3),
                        device="cpu")
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rs.randint(1, 250, (4, 8)).astype(np.int64))
        labels = toks.clone()
        labels[:, :2] = -100
        labels[3, 2:5] = -100            # shards with unequal label counts
        batches.append({"tokens": toks, "labels": labels})
    return model, base, peft, batches


@functools.lru_cache(maxsize=None)
def _one_device_steps(compress):
    model, base, peft, batches = _train_setup()
    opt = AdamW(lr=1e-2)
    step = make_train_step(model, opt, compress=compress)
    state = TrainState.create(base, peft, opt, compress=compress)
    out = []
    for batch in batches:
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


PSUM_XS = [torch.from_numpy(np.random.RandomState(7 + r).standard_normal(
    (5, 7)).astype(np.float32)) for r in range(2)]


# ------------------------------------------------------- pipeline inputs
L, M, MB, D = 8, 6, 2, 16


@functools.lru_cache(maxsize=None)
def _pipe_inputs():
    w = jax.random.normal(jax.random.PRNGKey(0), (L, D, D)) / np.sqrt(D)
    b = jax.random.normal(jax.random.PRNGKey(1), (L, D)) * 0.1
    x = jax.random.normal(jax.random.PRNGKey(2), (M, MB, D))
    return np.array(w), np.array(b), np.array(x)


@functools.lru_cache(maxsize=None)
def _jax_pipeline():
    """JAX's ``pipeline_apply`` on a 1-stage mesh: its outputs and the
    gradient of ``sum(out ** 2)``, in one jitted call."""
    w, b, x = _pipe_inputs()
    mesh = jax.make_mesh((1,), ("stage",))

    def layer_fn(lp, hh):
        return jnp.tanh(hh @ lp["w"] + lp["b"])

    def loss(p):
        out = j_pipeline_apply(layer_fn, p, jnp.asarray(x), mesh=mesh)
        return jnp.sum(out ** 2), out

    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    return np.asarray(out), {k: np.asarray(v) for k, v in grad.items()}


# -------------------------------------------------------- restore inputs
@functools.lru_cache(maxsize=None)
def _ckpt():
    """Two checkpoints of one train state: the port's store and the JAX
    store's (the JAX state carried over to the port's leaves)."""
    root = tempfile.mkdtemp(prefix="mesh_ckpt_")
    model, base, peft, _ = _train_setup()
    state = TrainState.create(base, peft, AdamW(lr=1e-2))
    save(os.path.join(root, "port"), 3, state)
    jm, jparams, _ = _jax_side(ARCH)
    j_store.save(os.path.join(root, "jax"), 5, {"params": jparams})
    return root, state, {"params": _zeros_to_torch(jparams)}


RESTORES = {"state (2, 1)": ((2, 1), "port", 3, "state"),
            "state (1, 2)": ((1, 2), "port", 3, "state"),
            "jax params (1, 2)": ((1, 2), "jax", 5, "params"),
            "jax rows (2, 1)": ((2, 1), "jax", 5, "rows")}


# ------------------------------------------- tensor parallelism inputs
TP_ARCHS = ("qwen2-0.5b", "llama2-7b-proxy")
TP_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _tp_pair(arch):
    """The JAX model with the shared numpy weights, folded and perturbed
    QuanTA on q/v and LoRA (B filled) on o_proj and down_proj in one
    adapter set, and the port's copies of the base and the set."""
    model, params, _ = _jax_side(arch)
    base, quanta = j_attach(jax.random.PRNGKey(1), params, JPeftConfig(
        method="quanta", n_axes=get_peft(arch).n_axes))
    _, lora = j_attach(jax.random.PRNGKey(2), base, JPeftConfig(
        method="lora", rank=4, targets=(r".*/(o_proj|down_proj)$",)))
    rs = np.random.RandomState(3)

    def noise(t, scale):
        return t + jnp.asarray(scale * rs.standard_normal(t.shape), t.dtype)

    tree = {"layers": {"attn": dict(quanta.tree["layers"]["attn"])}}
    for k, ad in quanta.tree["layers"]["attn"].items():
        tree["layers"]["attn"][k] = type(ad)(
            tuple(noise(t, 0.05) for t in ad.tensors), ad.dims_in,
            ad.dims_out, ad.pairs)
    for group, k in (("attn", "o_proj"), ("mlp", "down_proj")):
        ad = lora.tree["layers"][group][k]
        tree["layers"].setdefault(group, {})[k] = type(ad)(
            ad.a, noise(ad.b, 0.1), ad.alpha)
    peft = JAdapterSet(tree=tree, specs=quanta.specs + lora.specs)
    return (model, base, peft,
            interop.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             base), "cpu"),
            interop.adapter_set_from_numpy(peft, "cpu"))


def _tp_batch(vocab):
    rs = np.random.RandomState(4)
    toks = rs.randint(0, vocab, (3, 24)).astype(np.int32)
    lens = np.array([24, 7, 13], np.int32)
    steps = [rs.randint(0, vocab, (4, 1)).astype(np.int32) for _ in range(3)]
    return toks, lens, steps


@functools.lru_cache(maxsize=None)
def _tp_jax_logits(arch):
    """The JAX meshless model's prefill and decode-step logits."""
    jm, base, peft, _, _ = _tp_pair(arch)
    toks, lens, steps = _tp_batch(jm.cfg.vocab_size)
    logits, wave = jm.prefill(base, peft, {"tokens": jnp.asarray(toks)},
                              lengths=jnp.asarray(lens))
    out = [np.asarray(logits)]
    cache = jm.insert_cache(jm.init_cache(4, 48), np.array([2, 0, 1]), wave)
    for nxt in steps:
        logits, cache = jm.decode_step(base, peft, cache,
                                       {"tokens": jnp.asarray(nxt)})
        out.append(np.asarray(logits))
    return out


def _tp_job(arch, fault=False):
    jm, _, _, base, peft = _tp_pair(arch)
    toks, lens, steps = _tp_batch(jm.cfg.vocab_size)
    return "tp_model", dict(
        mesh_shape=(1, 2), arch=arch, base=base, peft=peft,
        tokens=torch.from_numpy(toks).long(), lens=torch.from_numpy(lens),
        steps=[torch.from_numpy(t).long() for t in steps], fault=fault)


def _refused_pefts():
    params, _ = _port_side(ARCH)
    return {method: attach(1, params, PeftConfig(method=method, rank=4,
                                                 n_axes=3, krona_a=8),
                           device="cpu")[1]
            for method in ("dora", "dota", "krona")}


# ------------------------------------------------------------- spawns
def _jobs(world):
    jobs = {}
    for shape in MESHES[world]:
        for case in CASES:
            jobs[(case, shape)] = _serve_job(case, shape)
        if shape[1] == 2:
            jobs[("tp leaves", shape)] = ("tp_leaves", dict(
                mesh_shape=shape, arch=ARCH, params=_port_side(ARCH)[0]))
        if shape[0] == 2:
            kw = _serve_job("preempt", shape)[1]
            kw.update(prompts=(), arena_probe=True)
            kw["engine_kw"] = dict(_kw("preempt"))
            jobs[("arena", shape)] = ("serve", kw)
            jobs[("uneven", shape)] = ("refusals", dict(mesh_shape=shape,
                                                        arch=ARCH))
            for quant in (None, "nf4"):
                q, k, v, t, lens, extra = _arena_inputs(quant)
                jobs[("decode", quant, shape)] = ("sharded_decode", dict(
                    mesh_shape=shape, q=torch.from_numpy(q),
                    k_pool=torch.from_numpy(k), v_pool=torch.from_numpy(v),
                    tables=torch.from_numpy(t), lens=torch.from_numpy(lens),
                    **_torch(extra)))
    if world == 2:
        for arch in TP_ARCHS:
            jobs[("tp model", arch)] = _tp_job(arch)
        jobs[("tp fault", TP_ARCHS[1])] = _tp_job(TP_ARCHS[1], fault=True)
        jobs["tp refusals"] = ("tp_refusals", dict(
            mesh_shape=(1, 2), arch=ARCH, params=_port_side(ARCH)[0],
            pefts=_refused_pefts()))
        model, base, peft, batches = _train_setup()
        for compress in (False, True):
            jobs[("train", compress)] = ("train_dp", dict(
                mesh_shape=(2, 1), arch=ARCH, params=base, peft=peft,
                batches=batches, compress=compress))
        jobs["psum"] = ("psum", dict(mesh_shape=(2, 1), xs=PSUM_XS))
        root, state, jtree = _ckpt()
        for name, (shape, which, step, kind) in RESTORES.items():
            template = state if which == "port" else jtree
            jobs[("restore", name)] = ("restore", dict(
                mesh_shape=shape, directory=os.path.join(root, which),
                step=step, template=template, spec_kind=kind, arch=ARCH))
    if world == 4:
        w, b, x = _pipe_inputs()
        jobs["pipeline"] = ("pipeline", dict(
            n_stages=4, w=torch.from_numpy(w), b=torch.from_numpy(b),
            x=torch.from_numpy(x)))
    return jobs


def _start(world, tmp_dir):
    """``world`` ranks forked from one server that has imported the rank
    side once (``W.PRELOAD``): a rank starts without importing torch."""
    jobs = _jobs(world)
    job_file = os.path.join(tmp_dir, "jobs.pt")
    torch.save(jobs, job_file)
    return mp.start_processes(
        W._rank_main, args=(world, os.path.join(tmp_dir, "store"), job_file,
                            tmp_dir),
        nprocs=world, join=False, start_method="forkserver")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's tensors are tiny: one intra-op thread a process, so
    that idle worker threads do not spin beside the ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both worlds' ranks started at once; the references computed while
    they run; then ``{world: {rank: {name: result}}}``."""
    import multiprocessing

    multiprocessing.get_context("forkserver").set_forkserver_preload(
        W.PRELOAD)
    dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in MESHES}
    ctxs = {}
    # the server's imports and the ranks run beside the references
    starter = threading.Thread(target=lambda: ctxs.update(
        (w, _start(w, d)) for w, d in dirs.items()))
    starter.start()
    for case in CASES:
        if CASES[case][0] == ARCH:
            _jax_tokens(case)
        _port_tokens(case)
    _jax_pipeline()
    for arch in TP_ARCHS:
        _tp_jax_logits(arch)
    starter.join()
    assert set(ctxs) == set(dirs), "the ranks did not start"
    for world, ctx in ctxs.items():
        try:
            while not ctx.join(timeout=600):
                pass
        except mp.ProcessExitedException as e:
            raise RuntimeError(f"world {world}: {e}\n"
                               f"{W.errors(dirs[world])}") from e
    return {w: {r: torch.load(os.path.join(d, f"rank{r}.pt"),
                              weights_only=False) for r in range(w)}
            for w, d in dirs.items()}


@pytest.fixture(scope="module")
def world2(spawned):
    return spawned[2]


@pytest.fixture(scope="module")
def world4(spawned):
    return spawned[4]


def _results(spawned, name):
    out = []
    for rank, res in sorted(spawned.items()):
        got = res[name]
        assert not (isinstance(got, dict) and "error" in got), got["error"]
        out.append(got)
    return out


def _world(request, shape):
    return request.getfixturevalue("world4" if shape == (2, 2) else "world2")


SHAPES = [(2, 1), (1, 2), (2, 2)]


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_engine_matches_single_device(case, shape, request):
    """Every rank's greedy tokens are the meshless port engine's and the
    JAX single-device engine's; the pool is cut into one arena a data
    shard; byte gauges count what the rank holds.  Over a `model` axis of
    2 the qwen2-0.5b engine splits its weights (no sharded leaf held
    whole); Griffin and Mamba2 keep `model` replicated."""
    runs = _results(_world(request, shape), (case, shape))
    arch = CASES[case][0]
    # Griffin and Mamba2 against the meshless port engine, which their
    # own test files hold against the JAX engines
    want = _jax_tokens(case) if arch == ARCH else _port_tokens(case)
    assert _port_tokens(case) == want
    for got in runs:
        assert got["done"]
        tokens = got["streams"] if case == "frontend" else got["tokens"]
        assert tokens == want, (case, shape)
        paged = CASES[case][2].get("cache") == "paged" and arch != \
            "mamba2-1.3b"
        assert got["data_shards"] == (shape[0] if paged else 1)
        assert got["eager"]                 # more than one rank
        assert got["model_shards"] == (shape[1] if arch == ARCH else 1)
        assert got["whole_sharded"] == []
        # drained: every block free, only the dense leaves billed
        assert got["stats"]["blocks_in_use"] == 0
        assert got["stats"]["cache_bytes_allocated"] == got["dense_bytes"]
        if not paged:
            assert got["dense_bytes"] == sum(got["leaf_bytes"].values())
        if case == "pool":
            assert got["pins"] == [0, 0, 0]
        if case == "preempt" and shape[0] == 2:
            assert got["stats"]["preemptions"] > 0
        if case == "chunked":
            assert got["stats"]["chunk_calls"] == -(-len(LONG) // 8)


def test_host_mesh_world_of_one_serves_as_meshless():
    """With no process group, ``make_host_mesh(1, 1, device="cpu")`` sets
    up a gloo world of one; a paged and a dense engine under it give the
    meshless tokens, hold whole leaves and keep one arena."""
    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh

    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        params, _ = _port_side(ARCH)
        model = build_model(get_smoke(ARCH), device="cpu")
        for case in ("dense", "paged"):
            eng = ServingEngine(model, params, device="cpu", mesh=mesh,
                                **_kw(case))
            assert _run(eng, _requests(Request, case), case) == \
                _port_tokens(case)
            assert not eng._decode.eager
            assert eng.pager is None or eng.pager.data_shards == 1
            assert all(t.to_local().shape == t.shape
                       for t in eng.placed_cache.values())
    finally:
        dist.destroy_process_group()


def _shard_bytes(params, shape):
    """Bytes one rank holds of ``params`` on a ``shape`` mesh: the
    replicated leaves whole, each leaf the decode rule shards over
    `model` at its ``local_shape``."""
    mesh = make_abstract_mesh(shape, ("data", "model"))
    specs = param_shardings(get_smoke(ARCH), mesh, params, decode=True)
    total = []
    map_with_paths(lambda _, t, sp: total.append(
        int(np.prod(local_shape(tuple(t.shape), sp, mesh)))
        * t.element_size()), params, specs)
    return sum(total)


def test_gauges_count_each_ranks_shards(world2, world4):
    """Per-rank byte gauges, counted from each rank's own leaves: a dense
    cache bills its data shard's slots of its KV heads (``1 / (data x
    model)`` of the meshless cache); params bill the replicated leaves
    plus each sharded leaf's ``local_shape`` (whole on ``(2, 1)``, less
    on ``(1, 2)`` and ``(2, 2)``); a ``(2, 1)`` paged pool bills one
    arena (a block's bytes: the local pool over its rows)."""
    params, _ = _port_side(ARCH)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    model = build_model(get_smoke(ARCH), device="cpu")
    one = ServingEngine(model, params, device="cpu", **_kw("dense"))
    kv = one.cache["k"].numel() * one.cache["k"].element_size()
    for spawned, shape in ((world2, (2, 1)), (world2, (1, 2)),
                           (world4, (2, 2))):
        want = _shard_bytes(params, shape)
        assert (want == whole) == (shape[1] == 1) and want <= whole
        for got in _results(spawned, ("dense", shape)):
            assert got["leaf_bytes"]["k"] * shape[0] * shape[1] == kv
            assert got["first_bytes"] == sum(got["leaf_bytes"].values())
            assert got["param_bytes"] == want
    pool = ServingEngine(model, params, device="cpu", n_blocks=34,
                         **_kw("paged"))
    rows = pool.pager.n_blocks
    pool_k = pool.cache["k"].numel() * pool.cache["k"].element_size()
    for got in _results(world2, ("paged", (2, 1))):
        assert got["leaf_bytes"]["k"] * 2 == pool_k
        assert got["per_block"] == pool.pager._bytes_per_block
        assert got["per_block"] * rows / 2 == sum(
            got["leaf_bytes"][k] for k in ("k", "v"))


# ------------------------------------------------- tensor parallelism
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_model_matches_jax(arch, world2):
    """``(1, 2)``: prefill and three decode steps on each rank's shards
    give the JAX meshless model's logits at 1e-4 on both ranks, over the
    rank's KV heads."""
    want = _tp_jax_logits(arch)
    for got in _results(world2, ("tp model", arch)):
        assert got["kv_heads"] == get_smoke(arch).n_kv_heads // 2
        assert len(got["logits"]) == len(want)
        for g, w in zip(got["logits"], want):
            np.testing.assert_allclose(g.numpy(), w, **TP_TOL)


def test_tp_skipped_all_reduce_is_caught(world2):
    """A planted fault: rank 0 keeps its own partial sums in place of the
    row-parallel ``all_reduce``; its logits leave the tolerance far
    behind."""
    want = _tp_jax_logits(TP_ARCHS[1])
    got = _results(world2, ("tp fault", TP_ARCHS[1]))[0]
    err = max(float(np.abs(g.numpy() - w).max())
              for g, w in zip(got["logits"], want))
    assert err > 100 * TP_TOL["atol"], err


def _jax_decode_specs(shape):
    _, jparams, _ = _jax_side(ARCH)
    specs = j_sh.param_shardings(j_get_smoke(ARCH), j_mesh.make_abstract_mesh(
        shape, ("data", "model")), jparams, decode=True)
    flat, _ = jax.tree_util.tree_flatten_with_path(specs)
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in flat}


def _flat(tree):
    out = {}
    map_with_paths(lambda p, t: out.__setitem__("/".join(p), t), tree)
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_local_leaves_match_jax_decode_specs(shape, request):
    """Each rank's ``local_params``: every leaf has the shape the JAX
    decode spec gives one rank and equals that rank's block of the whole
    leaf; placed as DTensors by the specs, the params give the same
    local leaves; packed NF4 from the shards, each projection decodes to
    its block of the whole weight packed NF4 (a row shard of o_proj reads
    half of its one quant block), and has the codes and scales that the
    whole packed weight's shards have."""
    params, _ = _port_side(ARCH)
    whole = _flat(params)
    packed = quantize_params(params, "nf4",
                             block_size=get_smoke(ARCH).quant_block_size)
    jspecs = _jax_decode_specs(shape)
    for got in _results(_world(request, shape), ("tp leaves", shape)):
        r = got["coord"]
        assert got["dtensor_same"]
        local = _flat(got["local"])
        assert set(local) == set(whole) == set(jspecs)
        for path, t in local.items():
            want = whole[path]
            for d, entry in enumerate(jspecs[path]):
                if entry == "model" or (isinstance(entry, tuple)
                                        and "model" in entry):
                    n = want.shape[d] // shape[1]
                    want = want.narrow(d, r * n, n)
            assert torch.equal(t, want), path
        for group in ("attn", "mlp"):
            for name, qw in got["nf4"]["layers"][group].items():
                if not name.endswith("proj"):
                    continue
                full = dequantize(packed["layers"][group][name])
                dim = -2 if name in ("o_proj", "down_proj") else -1
                n = full.shape[dim] // shape[1]
                assert torch.equal(dequantize(qw),
                                   full.narrow(dim, r * n, n)), name
                # the whole weight packed first: the same codes and scales
                again = got["nf4 packed"]["layers"][group][name]
                assert torch.equal(again.packed, qw.packed), name
                assert torch.equal(again.scales, qw.scales), name


def test_tp_refusals(world2):
    """Under a `model` split of 2: KV heads it does not divide raise
    (naming the head_dim split), and so do DoRA, DoTA and KronA."""
    for got in _results(world2, "tp refusals"):
        assert "head_dim split" in got["kv heads"]
        for method in ("dora", "dota", "krona"):
            assert got[method] is not None and \
                "not served on a `model` shard" in got[method], method


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_admission_skips_full_arena(shape, request):
    """A full arena does not hold up admission: slot 1 is free but its
    arena (shard 0) is full of the hog in slot 0, and a late request
    admits into a shard-1 slot at the next step."""
    for got in _results(_world(request, shape), ("arena", shape)):
        assert got["quick_done"] and got["arena0_full"]
        assert got["late_admitted"] and got["late_done"]


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_uneven_slot_split_rejected(shape, request):
    """``n_slots`` that the data axes do not divide raises, as in the JAX
    engine: the slot axis shards over them."""
    for got in _results(_world(request, shape), ("uneven", shape)):
        assert got is not None and "multiple of the mesh" in got


# ----------------------------------------------------- the paged decode
@pytest.mark.parametrize("quant", [None, "nf4"])
def test_per_shard_body_matches_global_decode_and_jax(quant):
    """One process, shard by shard: each arena's decode through its
    shifted tables, stacked, is the global plain paged decode and the
    JAX kernel in interpret mode at 2e-5; unshifted tables are caught."""
    q, k, v, t, lens, extra = _arena_inputs(quant)
    want = _jax_decode(quant)
    tq, tk, tv, tt, tl = (torch.from_numpy(a) for a in (q, k, v, t, lens))
    ex = _torch(extra)
    whole = FA.paged_flash_decode_attention(tq, tk, tv, tt, tl, **ex)
    rows, arena = 2, k.shape[0] // 2
    parts = []
    for shard in range(2):
        sl, al = slice(shard * rows, (shard + 1) * rows), \
            slice(shard * arena, (shard + 1) * arena)
        scales = {n: (a[al] if n.endswith("scales") else a)
                  for n, a in ex.items()}
        parts.append(paged_decode_shard(
            tq[sl], tk[al], tv[al], tt[sl], tl[sl], shard, **scales))
    got = torch.cat(parts)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # planted fault, four arenas: shard 1's tables left unshifted read
    # shard 2's arena (the pool view runs on to the pool's end)
    q4, k4, v4, t4, l4, x4 = _arena_inputs(quant, d=4, seed=3)
    tq4, tk4, tv4, tt4, tl4 = (torch.from_numpy(a)
                               for a in (q4, k4, v4, t4, l4))
    ex4 = _torch(x4)
    a4 = k4.shape[0] // 4
    right = paged_decode_shard(
        tq4[1:2], tk4[a4:2 * a4], tv4[a4:2 * a4], tt4[1:2], tl4[1:2], 1,
        **{n: (a[a4:2 * a4] if n.endswith("scales") else a)
           for n, a in ex4.items()})
    wrong = paged_decode_shard(
        tq4[1:2], tk4[a4:], tv4[a4:], tt4[1:2], tl4[1:2], 0,
        **{n: (a[a4:] if n.endswith("scales") else a)
           for n, a in ex4.items()})
    full = FA.paged_flash_decode_attention(tq4, tk4, tv4, tt4, tl4, **ex4)
    torch.testing.assert_close(right, full[1:2], rtol=2e-5, atol=2e-5)
    assert (wrong - right).abs().max() > 1e-2


@pytest.mark.parametrize("quant", [None, "nf4"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_paged_decode_across_ranks(shape, quant, request):
    """``paged_decode_attention(mesh=)`` on each rank: its rows of the
    output, stacked over the data shards, are the global plain decode
    and the JAX kernel's at 2e-5."""
    q, k, v, t, lens, extra = _arena_inputs(quant)
    want = _jax_decode(quant)
    runs = _results(_world(request, shape), ("decode", quant, shape))
    assert all(r["sharded"] for r in runs)
    by_shard = {r["shard"]: r["local"] for r in runs}
    got = torch.cat([by_shard[s] for s in sorted(by_shard)])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------- training
@pytest.mark.parametrize("compress", [False, True])
def test_dp_train_steps_match_one_device(compress, world2):
    """3 steps on ``(2, 1)`` (shards with unequal label counts): every
    rank's loss and grad norm within 1e-5 of the single-device step."""
    want = _one_device_steps(compress)
    for got in _results(world2, ("train", compress)):
        np.testing.assert_allclose(np.array(got), np.array(want),
                                   rtol=1e-5, atol=1e-5)


def test_compressed_psum_matches_jax_compression(world2):
    want = sum(np.asarray(q, np.float32) * np.asarray(s)
               for q, s in (j_compress_int8(jnp.asarray(x.numpy()))
                            for x in PSUM_XS))
    for got in _results(world2, "psum"):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- pipeline
def test_pipeline_four_stages_matches_sequential_and_jax(world4):
    w, b, x = _pipe_inputs()
    tw, tb, tx = (torch.from_numpy(a) for a in (w, b, x))
    tw.requires_grad_(True)
    tb.requires_grad_(True)
    h = tx
    for i in range(L):
        h = torch.tanh(h @ tw[i] + tb[i])
    (h ** 2).sum().backward()
    j_out, j_grad = _jax_pipeline()
    runs = _results(world4, "pipeline")
    per = L // 4
    for stage, got in enumerate(runs):
        for ref in (h.detach().numpy(), j_out):
            np.testing.assert_allclose(got["out"].numpy(), ref, rtol=2e-5,
                                       atol=2e-5)
    for name, seq in (("w", tw.grad), ("b", tb.grad)):
        # each stage holds its own layers' gradient, zeros elsewhere
        whole = sum(r[name] for r in runs)
        for stage, got in enumerate(runs):
            own = slice(stage * per, (stage + 1) * per)
            assert not got[name][:own.start].any()
            assert not got[name][own.stop:].any()
        for ref in (seq.numpy(), np.asarray(j_grad[name])):
            np.testing.assert_allclose(whole.numpy(), ref, rtol=5e-4,
                                       atol=5e-4)


# ------------------------------------------------------------- restores
def _expected_slice(full, shape, rank, placements):
    """The block of ``full`` that rank ``rank`` of a row-major
    ``shape`` mesh holds under ``placements`` (``Shard(d)`` /
    ``Replicate()``, one a mesh dim)."""
    coord = np.unravel_index(rank, shape)
    out = full
    for i, p in enumerate(placements):
        if p.startswith("S("):
            d = int(p[2:-1])
            out = out.chunk(shape[i], dim=d)[coord[i]]
    return out


@pytest.mark.parametrize("name", list(RESTORES))
def test_restore_resharded_onto_meshes(name, world2):
    shape, which, step, _ = RESTORES[name]
    root, state, jtree = _ckpt()
    template = state if which == "port" else jtree
    whole = dict(zip(*tree_flatten_with_paths(restore(
        os.path.join(root, which), step, template, device="cpu"))))
    split = 0
    for rank, got in enumerate(_results(world2, ("restore", name))):
        assert set(got) == set(whole)
        for path, (local, placements) in got.items():
            if placements is None:
                assert local == whole[path]
                continue
            want = _expected_slice(whole[path], shape, rank, placements)
            split += local.shape != whole[path].shape
            assert local.dtype == want.dtype and torch.equal(
                local.view(torch.uint8) if local.dtype == torch.bfloat16
                else local, want.view(torch.uint8)
                if want.dtype == torch.bfloat16 else want), (name, path)
    # a (2, 1) mesh places the state's params on a `model` axis of one,
    # so whole; every other case splits leaves
    assert (split > 0) == (name != "state (2, 1)")
