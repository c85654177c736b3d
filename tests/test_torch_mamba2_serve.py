"""The port's engines on the mamba2-1.3b SMOKE config (2 layers, SSD
chunks of 8, so prompts of up to 45 tokens run several chunks) generate
the JAX engine's greedy tokens on every serving path: the dense O(1)
state cache, ``cache="paged"`` (Mamba2 has no token-axis leaf, so the
paged view is the dense cache, with its bytes), NF4 KV asked for (nothing
to quantize: the same cache), an NF4 base (x_proj, z_proj and out_proj
packed; bc_proj and dt_proj dense), chunked prefill asked for (Mamba2 has
no chunk step, so both engines admit by waves), replay admission (the
prompts stepped through the recurrence), a bank of two tenants (folded
QuanTA on x_proj, z_proj and out_proj, and LoRA) beside the base, the
same with a fold-free QuanTA tenant (banked bare over the shared base),
and a capacity-1 adapter pool that churns.  10 train steps of QuanTA agree with
the JAX train step at 1e-4.  Weights, adapters and tenants come from the
JAX package (perturbations from numpy seeds) through ``interop``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

ARCH = "mamba2-1.3b"
# the chunk of the dual form: prompts of up to 45 tokens take several
CHUNK = 8
PROMPTS = [[3, 141, 59] * 15, [26, 5], [35, 89, 79, 32] * 4, [38, 46],
           [2, 7, 18], [200, 1, 9, 9, 40] * 5]
# path -> (cfg.kv_quant, engine options, tenants: None | "bank" |
# "foldfree bank" | "pool")
PATHS = {
    "dense": (None, dict(), None),
    "paged": (None, dict(cache="paged", block_size=8), None),
    "nf4 KV": ("nf4", dict(cache="paged", block_size=8, kv_quant="nf4"),
               None),
    "nf4 base": (None, dict(base_quant="nf4"), None),
    "chunked": (None, dict(prefill_chunk=8), None),
    "replay": (None, dict(admission="replay"), None),
    "bank": (None, dict(), "bank"),
    "foldfree bank": (None, dict(), "foldfree bank"),
    "pool": (None, dict(), "pool"),
}
# each request's tenant: the bank cycles through two tenants and the base;
# the pool's two LoRA tenants share one structure group, whose one row
# they take in turns
TENANTS = {"bank": ("qa", "lo", None),
           "foldfree bank": ("ff", "lo", None),
           "pool": ("lo", "l2", None, "qa", "lo", "l2")}


@functools.lru_cache(maxsize=None)
def _jax_weights():
    jm = j_build_model(j_get_smoke(ARCH).replace(ssm_chunk=CHUNK))
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
    _, ffset = jax.jit(lambda p: j_attach(
        jax.random.PRNGKey(7), p, JPeftConfig(
            method="quanta", n_axes=peft_cfg.n_axes, fold=False,
            targets=peft_cfg.targets)))(params)
    ffset = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), ffset)
    lora = [ffset]
    lora_attach = jax.jit(lambda key, p: j_attach(key, p, JPeftConfig(
        method="lora", rank=4, targets=peft_cfg.targets))[1])
    for key in (2, 5):
        lset = lora_attach(jax.random.PRNGKey(key), params)
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
    jm = j_build_model(j_get_smoke(ARCH).replace(kv_quant=kv_quant,
                                                 ssm_chunk=CHUNK))
    opts = dict(opts, admission=opts.get("admission", "prefill"))
    entries = {"qa": (qbase, qset), "ff": lora[0], "lo": lora[1],
               "l2": lora[2]}
    if tenants in ("bank", "foldfree bank"):
        eng = JEngine(jm, params, adapters=JBank.build(params, entries),
                      n_slots=3, max_len=64, **opts)
    elif tenants == "pool":
        store = JStore(max_tenants=5)
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
        attn_backend="pallas", peft_backend="pallas", kv_quant=kv_quant,
        ssm_chunk=CHUNK), device="cpu")
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    if tenants:
        tparams = interop.params_from_numpy(np_tree(params), "cpu")
        entries = {"qa": interop.tenant_from_numpy((qbase, qset), "cpu"),
                   "ff": interop.tenant_from_numpy(lora[0], "cpu"),
                   "lo": interop.tenant_from_numpy(lora[1], "cpu"),
                   "l2": interop.tenant_from_numpy(lora[2], "cpu")}
        if tenants in ("bank", "foldfree bank"):
            adapters = AdapterBank.build(tparams, entries)
        else:
            store = AdapterStore(max_tenants=5)
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
    assert max(len(p) for p in PROMPTS) > 4 * CHUNK
    if path in ("chunked", "replay"):
        # no chunk step: admitted by waves (or stepped), as the JAX engine
        assert eng.stats["chunk_calls"] == 0 == jstats["chunk_calls"]
        assert eng.stats["prefill_calls"] == jstats["prefill_calls"]
    if path == "pool":
        assert eng.stats["adapter_loads"] == jstats["adapter_loads"] >= 4
        assert (eng.stats["adapter_evictions"]
                == jstats["adapter_evictions"] >= 1)
    if path in ("paged", "nf4 KV"):
        # no token-axis leaf: nothing paged, nothing quantized, the dense
        # cache's bytes
        assert not eng.pager.paged and eng.pager.n_blocks == 0
        dense = tm.init_cache(3, 64)
        assert set(eng.cache) == set(dense) == {"ssm", "conv", "len"}
        assert eng.stats["cache_bytes_allocated"] == sum(
            t.numel() * t.element_size() for t in dense.values())
        assert eng.cache["ssm"].dtype == torch.float32
    if path == "nf4 base":
        layers = eng.params["layers"]
        assert all(type(layers[k]).__name__ == "QuantizedLinear"
                   for k in ("x_proj", "z_proj", "out_proj"))
        assert all(isinstance(layers[k], torch.Tensor)
                   for k in ("bc_proj", "dt_proj"))


def test_ten_train_steps_match_jax():
    """10 AdamW steps of QuanTA on the config's targets (x_proj, z_proj,
    out_proj) at 1e-4 against the JAX train step, through the chunked
    dual form (sequences of 32 in chunks of 8); the base never takes a
    gradient."""
    _, qbase, qset, _ = _jax_weights()
    jm = j_build_model(j_get_smoke(ARCH).replace(ssm_chunk=CHUNK))
    kw = dict(vocab_size=256, seq_len=32, global_batch=8, task_rank=8)
    jdata, tdata = JTask(**kw), SyntheticSeq2Task(**kw)
    jopt, topt = JAdamW(lr=5e-3), AdamW(lr=5e-3)
    jstate = JState.create(qbase, qset, jopt)
    jstep = jax.jit(j_step(jm, jopt))
    tm = build_model(get_smoke(ARCH).replace(ssm_chunk=CHUNK),
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
    assert sorted(tstate.peft.paths) == ["layers/out_proj", "layers/x_proj",
                                         "layers/z_proj"]
    for a, b in zip(tree_leaves(tstate.params), tree_leaves(tbase)):
        assert a is b and not a.requires_grad and a.grad is None
