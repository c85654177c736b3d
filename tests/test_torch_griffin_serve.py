"""The port's engines on the recurrentgemma-2b SMOKE config (Griffin: one
macro block and a 1-layer tail, a 32-row local-attention ring) generate
the JAX engine's greedy tokens on every serving path: the dense ring,
paged rings of rows and of NF4 and int8 codes, an NF4 base, chunked
prefill asked for (Griffin has no chunk step, so both engines admit by
waves), replay admission, a bank of two tenants (folded QuanTA on the
config's six kinds of path, the unstacked tail among them, and LoRA)
beside the base, and a capacity-1 adapter pool that churns; the longest
request runs past the window, so every ring wraps.  10 train steps of
QuanTA agree with the JAX train step at 1e-4.  Weights, adapters and
tenants come from the JAX package (perturbations from numpy seeds)
through ``interop``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke as j_get_smoke
from repro.core.bank import AdapterBank as JBank
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.data import SyntheticSeq2Task as JTask
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro.serve import (
    AdapterPool as JPool, AdapterStore as JStore, Request as JRequest,
    ServingEngine as JEngine,
)
from repro.train import TrainState as JState, make_train_step as j_step
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.adapters import tree_leaves
from repro_torch.core.bank import AdapterBank
from repro_torch.data import SyntheticSeq2Task
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.serve import (
    AdapterPool, AdapterStore, Request, ServingEngine,
)

ARCH = "recurrentgemma-2b"
# the longest request (45 prompt tokens + 8 new) runs past the 32-row ring
PROMPTS = [[3, 141, 59] * 15, [26, 5], [35, 89, 79, 32] * 4, [38, 46],
           [2, 7, 18], [200, 1, 9, 9, 40] * 5]
# path -> (cfg.kv_quant, engine options, tenants: None | "bank" | "pool")
PATHS = {
    "dense": (None, dict(), None),
    "paged": (None, dict(cache="paged", block_size=8), None),
    "nf4 KV": ("nf4", dict(cache="paged", block_size=8, kv_quant="nf4"),
               None),
    "int8 KV": ("int8", dict(cache="paged", block_size=8, kv_quant="int8"),
                None),
    "nf4 base": (None, dict(base_quant="nf4"), None),
    "chunked": (None, dict(prefill_chunk=8), None),
    "replay": (None, dict(admission="replay"), None),
    "bank": (None, dict(), "bank"),
    "pool": (None, dict(), "pool"),
}
# each request's tenant: the bank cycles through two tenants and the base;
# the pool's two LoRA tenants share one structure group, whose one row
# they take in turns
TENANTS = {"bank": ("qa", "lo", None),
           "pool": ("lo", "l2", None, "qa", "lo", "l2")}


@functools.lru_cache(maxsize=None)
def _jax_weights():
    jm = j_build_model(j_get_smoke(ARCH))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    peft_cfg = get_peft(ARCH)
    qbase, qset = jax.jit(lambda p: j_attach(
        jax.random.PRNGKey(1), p, JPeftConfig(
            method="quanta", n_axes=peft_cfg.n_axes,
            targets=peft_cfg.targets)))(params)
    rs = np.random.RandomState(3)
    qset = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), qset)
    lora = []
    for key in (2, 5):
        _, lset = jax.jit(lambda p: j_attach(
            jax.random.PRNGKey(key), p, JPeftConfig(method="lora",
                                                    rank=4)))(params)
        lora.append(jax.tree_util.tree_map(
            lambda t: t + jnp.asarray(0.15 * rs.standard_normal(t.shape),
                                      t.dtype), lset))
    return params, qbase, qset, lora


def _run(eng, make, tenants):
    reqs = [make(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    names = TENANTS.get(tenants)
    for i, r in enumerate(reqs):
        eng.submit(r, adapter=names[i % len(names)] if names else None)
    eng.run()
    assert all(r.done and len(r.output) == 8 for r in reqs)
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_run(path):
    kv_quant, opts, tenants = PATHS[path]
    params, qbase, qset, lora = _jax_weights()
    jm = j_build_model(j_get_smoke(ARCH).replace(kv_quant=kv_quant))
    opts = dict(opts, admission=opts.get("admission", "prefill"))
    entries = {"qa": (qbase, qset), "lo": lora[0], "l2": lora[1]}
    if tenants == "bank":
        eng = JEngine(jm, params, adapters=JBank.build(params, entries),
                      n_slots=3, max_len=64, **opts)
    elif tenants == "pool":
        store = JStore(max_tenants=4)
        for name, entry in entries.items():
            store.register(name, entry)
        eng = JEngine(jm, params, adapters=JPool.build(params, store,
                                                       capacity=1),
                      n_slots=3, max_len=64, **opts)
    else:
        eng = JEngine(jm, qbase, qset, n_slots=3, max_len=64, **opts)
    return _run(eng, JRequest, tenants), dict(eng.stats)


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_tokens_match_jax(path):
    kv_quant, opts, tenants = PATHS[path]
    params, qbase, qset, lora = _jax_weights()
    tm = build_model(get_smoke(ARCH).replace(
        attn_backend="pallas", peft_backend="pallas", kv_quant=kv_quant),
        device="cpu")
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    if tenants:
        tparams = interop.params_from_numpy(np_tree(params), "cpu")
        entries = {"qa": interop.tenant_from_numpy((qbase, qset), "cpu"),
                   "lo": interop.tenant_from_numpy(lora[0], "cpu"),
                   "l2": interop.tenant_from_numpy(lora[1], "cpu")}
        if tenants == "bank":
            adapters = AdapterBank.build(tparams, entries)
        else:
            store = AdapterStore(max_tenants=4)
            for name, entry in entries.items():
                store.register(name, entry)
            adapters = AdapterPool.build(tparams, store, capacity=1)
        eng = ServingEngine(tm, tparams, adapters=adapters, n_slots=3,
                            max_len=64, device="cpu", **opts)
    else:
        tqbase = interop.params_from_numpy(np_tree(qbase), "cpu")
        eng = ServingEngine(tm, tqbase, interop.adapter_set_from_numpy(
            qset, "cpu"), n_slots=3, max_len=64, device="cpu", **opts)
    got = _run(eng, Request, tenants)
    want, jstats = _jax_run(path)
    assert got == want
    assert max(len(p) for p in PROMPTS) + 8 > get_smoke(ARCH).local_window
    if path == "chunked":
        # no chunk step: admitted by waves, as the JAX engine does
        assert eng.stats["chunk_calls"] == 0 == jstats["chunk_calls"]
        assert eng.stats["prefill_calls"] == jstats["prefill_calls"]
    if path == "pool":
        assert eng.stats["adapter_loads"] == jstats["adapter_loads"] >= 4
        assert (eng.stats["adapter_evictions"]
                == jstats["adapter_evictions"] >= 1)
    if path == "nf4 KV":
        # the int32 ring positions stay unquantized beside the codes
        assert eng.cache["pos"].dtype.is_floating_point is False
        assert eng.cache["k"].dtype.itemsize == 1 and "k_qscale" in eng.cache
        assert "pos_qscale" not in eng.cache
    if path == "paged":
        # a ring slot never holds more than window / block_size blocks
        assert eng.pager.max_blocks_per_slot == 32 // 8
        assert eng.stats["peak_blocks_in_use"] <= 3 * 4


def test_ten_train_steps_match_jax():
    """10 AdamW steps of QuanTA on the config's targets (attention q/v and
    every rec_proj, the tail's among them) at 1e-4 against the JAX train
    step; the base never takes a gradient."""
    _, qbase, qset, _ = _jax_weights()
    jm = j_build_model(j_get_smoke(ARCH))
    kw = dict(vocab_size=256, seq_len=32, global_batch=16, task_rank=8)
    jdata, tdata = JTask(**kw), SyntheticSeq2Task(**kw)
    jopt, topt = JAdamW(lr=5e-3), AdamW(lr=5e-3)
    jstate = JState.create(qbase, qset, jopt)
    jstep = jax.jit(j_step(jm, jopt))
    tm = build_model(get_smoke(ARCH).replace(attn_backend="pallas"),
                     device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, qbase), "cpu")
    from repro_torch.train import TrainState, make_train_step

    tstate = TrainState.create(tbase, interop.adapter_set_from_numpy(
        qset, "cpu"), topt)
    tstep = make_train_step(tm, topt)
    want, got = [], []
    for i in range(10):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in jdata.batch(i).items()})
        tstate, tm_ = tstep(tstate, tdata.batch(i))
        want.append((float(jm_["loss"]), float(jm_["grad_norm"])))
        got.append((float(tm_["loss"]), float(tm_["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert got[-1][0] < got[0][0]
    assert "tail/rec1/rec_proj" in tstate.peft.paths
    for a, b in zip(tree_leaves(tstate.params), tree_leaves(tbase)):
        assert a is b and not a.requires_grad and a.grad is None
