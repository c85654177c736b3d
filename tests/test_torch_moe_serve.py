"""The port's engines on the mixtral-8x7b SMOKE config (MoE, top-2 of 4
experts, a 48-token window) generate the JAX engine's greedy tokens on
every serving path: the dense cache, a paged pool of rows, paged NF4 KV
codes, an NF4 base (the 4-D expert stacks stay unquantized, as the JAX
package leaves them), chunked prefill, replay admission and a bank of two
tenants (folded QuanTA and LoRA) beside the base; and 10 train steps of
QuanTA on it agree with the JAX train step at 1e-4.  Weights, adapters
and tenants come from the JAX package (perturbations from numpy seeds)
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
from repro.serve import Request as JRequest, ServingEngine as JEngine
from repro.train import TrainState as JState, make_train_step as j_step
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.adapters import tree_leaves
from repro_torch.core.bank import AdapterBank
from repro_torch.data import SyntheticSeq2Task
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.serve import Request, ServingEngine

ARCH = "mixtral-8x7b"
# the longest request (45 prompt tokens + 8 new) decodes past the window
PROMPTS = [[3, 141, 59] * 15, [26, 5], [35, 89, 79, 32] * 4, [38, 46],
           [2, 7, 18]]
# path -> (cfg.kv_quant, engine options, tenants)
PATHS = {
    "dense": (None, dict(), False),
    "paged": (None, dict(cache="paged", block_size=8), False),
    "nf4 KV": ("nf4", dict(cache="paged", block_size=8, kv_quant="nf4"),
               False),
    "nf4 base": (None, dict(base_quant="nf4"), False),
    "chunked": (None, dict(prefill_chunk=8), False),
    "replay": (None, dict(admission="replay"), False),
    "bank": (None, dict(), True),
}
TENANTS = ("qa", "lo", None)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    jm = j_build_model(j_get_smoke(ARCH))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    qbase, qset = jax.jit(lambda p: j_attach(
        jax.random.PRNGKey(1), p, JPeftConfig(
            method="quanta", n_axes=get_peft(ARCH).n_axes)))(params)
    rs = np.random.RandomState(3)
    qset = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), qset)
    _, lset = j_attach(jax.random.PRNGKey(2), params,
                       JPeftConfig(method="lora", rank=4))
    lset = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.15 * rs.standard_normal(t.shape),
                                  t.dtype), lset)
    return params, qbase, qset, lset


def _run(eng, make, bank):
    reqs = [make(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    for i, r in enumerate(reqs):
        eng.submit(r, adapter=TENANTS[i % 3] if bank else None)
    eng.run()
    assert all(r.done and len(r.output) == 8 for r in reqs)
    return [r.output for r in reqs]


def _jax_tokens(path):
    kv_quant, opts, bank = PATHS[path]
    params, qbase, qset, lset = _jax_weights()
    jm = j_build_model(j_get_smoke(ARCH).replace(kv_quant=kv_quant))
    opts = dict(opts, admission=opts.get("admission", "prefill"))
    if bank:
        eng = JEngine(jm, params, adapters=JBank.build(
            params, {"qa": (qbase, qset), "lo": lset}), n_slots=3,
            max_len=64, **opts)
    else:
        eng = JEngine(jm, qbase, qset, n_slots=3, max_len=64, **opts)
    return _run(eng, JRequest, bank)


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_tokens_match_jax(path):
    kv_quant, opts, bank = PATHS[path]
    params, qbase, qset, lset = _jax_weights()
    tm = build_model(get_smoke(ARCH).replace(
        attn_backend="pallas", peft_backend="pallas", kv_quant=kv_quant),
        device="cpu")
    tqbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, qbase), "cpu")
    tqset = interop.adapter_set_from_numpy(qset, "cpu")
    if bank:
        tparams = interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), "cpu")
        adapters = AdapterBank.build(tparams, {
            "qa": (tqbase, tqset),
            "lo": interop.adapter_set_from_numpy(lset, "cpu")})
        eng = ServingEngine(tm, tparams, adapters=adapters, n_slots=3,
                            max_len=64, device="cpu", **opts)
    else:
        eng = ServingEngine(tm, tqbase, tqset, n_slots=3, max_len=64,
                            device="cpu", **opts)
    got = _run(eng, Request, bank)
    assert got == _jax_tokens(path)
    assert max(len(p) for p in PROMPTS) + 8 > get_smoke(ARCH).sliding_window
    if path == "nf4 base":
        moe = eng.params["layers"]["moe"]
        assert all(t.dim() in (3, 4) and t.is_floating_point()
                   for t in moe.values())
    if path in ("dense", "nf4 base"):
        # param_bytes counts the 4-D expert stacks
        moe_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves(tqbase["layers"]["moe"]))
        assert eng.stats["param_bytes"] > moe_bytes > 0


def test_ten_train_steps_match_jax():
    """10 AdamW steps of QuanTA (the loss with its aux term, drops at the
    config's capacity factor) at 1e-4 against the JAX train step; the
    router and experts never take a gradient."""
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
    for a, b in zip(tree_leaves(tstate.params), tree_leaves(tbase)):
        assert a is b and not a.requires_grad and a.grad is None
