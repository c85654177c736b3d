"""The port's multi-tenant ``AdapterBank`` held against the JAX package:
``build`` lays out the same leaves, ``id_maps`` and group order bit for
bit, and the port's engine serving a bank generates the JAX bank engine's
greedy tokens exactly and each tenant's single-tenant tokens, for a mixed
folded-QuanTA + LoRA + base batch and for a fold-free QuanTA + LoRA +
base batch on the llama2-7b-proxy and qwen2-0.5b SMOKE configs, on the
dense cache and on a paged pool small enough to preempt (the preempted
requests keep their tenants); also with LoRA
groups of two ranks and DoRA, DoTA and KronA tenants, and under an NF4
base.  Tenants are made by the JAX package (noise from numpy seeds) and
carried over as numpy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.bank import AdapterBank as JBank
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest, ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.adapters import tree_leaves
from repro_torch.core.bank import AdapterBank, BankedAdapter
from repro_torch.core.peft import PeftConfig, attach, flatten_paths
from repro_torch.models import build_model
from repro_torch.serve import Request, ServingEngine

PROMPTS = [[5, 9, 13], [40, 2], [7, 7, 7, 7, 21, 3, 99], [100, 101],
           [1], [13, 5, 88, 4, 2], [250, 3, 17], [9] * 11]
MAX_NEW = 5
ARCHS = ["llama2-7b-proxy", "qwen2-0.5b"]
# cache case -> engine options; 6 blocks of 4 tokens cannot hold three
# growing requests, so the tight pool preempts (checked below)
CACHES = {"dense": dict(cache="dense"),
          "paged tight": dict(cache="paged", block_size=4, n_blocks=6)}


def _noise(tree, seed, scale=0.15):
    """``tree`` plus numpy Gaussian noise, so each tenant's tokens differ
    from the base model's."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(scale * rs.standard_normal(t.shape),
                                  t.dtype), tree)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    model = j_build_model(j_get_smoke(arch))
    return model, model.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_tenants(arch, kind="mixed"):
    """name -> tenant entry (JAX): folded QuanTA (the attach pair) + LoRA
    ("mixed"); two fold-free QuanTA tenants (one structure group) + LoRA
    ("foldfree"); LoRA ranks 4 and 8, DoRA, DoTA and KronA ("hetero")."""
    _, params = _jax_model(arch)
    if kind == "foldfree":
        out = {}
        for i in range(2):
            _, fset = j_attach(jax.random.PRNGKey(5 + i), params,
                               JPeftConfig(method="quanta", fold=False,
                                           n_axes=get_peft(arch).n_axes,
                                           noise_scale=0.3))
            out[f"f{i}"] = _noise(fset, 7 + i, 0.1)
        _, lset = j_attach(jax.random.PRNGKey(2), params,
                           JPeftConfig(method="lora", rank=4))
        out["lo"] = _noise(lset, 3)
        return out
    if kind == "mixed":
        qbase, qset = j_attach(jax.random.PRNGKey(1), params, JPeftConfig(
            method="quanta", n_axes=get_peft(arch).n_axes, noise_scale=0.3))
        _, lset = j_attach(jax.random.PRNGKey(2), params,
                           JPeftConfig(method="lora", rank=4))
        return {"qa": (qbase, qset), "lo": _noise(lset, 3)}
    out = {}
    for i, (name, cfg, scale) in enumerate((
            ("r4", JPeftConfig(method="lora", rank=4), 0.15),
            ("r8", JPeftConfig(method="lora", rank=8), 0.15),
            ("do", JPeftConfig(method="dora", rank=4), 0.05),
            ("dt", JPeftConfig(method="dota", rank=2, n_axes=3), 0.05),
            ("kr", JPeftConfig(method="krona", krona_a=8), 0.05))):
        _, aset = j_attach(jax.random.PRNGKey(10 + i), params, cfg)
        out[name] = _noise(aset, 20 + i, scale)
    return out


def _assigns(names):
    rotation = list(names) + [None]
    return [(i, p, rotation[i % len(rotation)])
            for i, p in enumerate(PROMPTS)]


def _run(engine, make, assigns, bank):
    reqs = []
    for uid, prompt, tenant in assigns:
        r = make(uid=uid, prompt=list(prompt), max_new_tokens=MAX_NEW)
        engine.submit(r, adapter=tenant if bank else None)
        reqs.append(r)
    engine.run()
    assert all(r.done for r in reqs)
    return {r.uid: r.output for r in reqs}


@functools.lru_cache(maxsize=None)
def _jax_bank_run(arch, kind, case, base_quant=None):
    model, params = _jax_model(arch)
    tenants = _jax_tenants(arch, kind)
    bank = JBank.build(params, tenants)
    eng = JEngine(model, params, adapters=bank, n_slots=3, max_len=64,
                  base_quant=base_quant, **CACHES[case])
    return _run(eng, JRequest, _assigns(tenants), True), \
        eng.stats["preemptions"]


@functools.lru_cache(maxsize=None)
def _port_tenants(arch, kind="mixed"):
    _, params = _jax_model(arch)
    tparams = interop.params_from_numpy(params, "cpu")
    return tparams, {n: interop.tenant_from_numpy(e, "cpu")
                     for n, e in _jax_tenants(arch, kind).items()}


def _port_engine(arch, params, backend, peft=None, adapters=None, **kw):
    model = build_model(get_smoke(arch).replace(
        attn_backend=backend, peft_backend=backend), device="cpu")
    return ServingEngine(model, params, peft, adapters=adapters, n_slots=3,
                         max_len=64, device="cpu", **kw)


def _single_tenant(arch, kind, backend, name, assigns, **kw):
    """Tokens of one tenant's requests on its own single-tenant engine."""
    tparams, tenants = _port_tenants(arch, kind)
    entry = tenants.get(name)
    params, peft = entry if isinstance(entry, tuple) else (tparams, entry)
    eng = _port_engine(arch, params, backend, peft=peft, **kw)
    return _run(eng, Request, [a for a in assigns if a[2] == name], False)


# ------------------------------------------------------------- layout
@pytest.mark.parametrize("arch", ARCHS)
def test_bank_build_equals_jax(arch):
    """Same paths, group order, delta forms and id_maps, and the same
    bank-stacked leaves (bank axis 1 behind the layers) bit for bit."""
    _, params = _jax_model(arch)
    jbank = JBank.build(params, _jax_tenants(arch))
    tparams, tenants = _port_tenants(arch)
    bank = AdapterBank.build(tparams, tenants)
    assert bank.names == jbank.names == ("qa", "lo")
    jflat, tflat = flatten_paths(jbank.tree), flatten_paths(bank.tree)
    assert sorted(jflat) == sorted(tflat) and len(tflat) == 2
    for path, jnode in jflat.items():
        node = tflat[path]
        assert node.stacked and jnode.stacked
        assert node.delta_forms == jnode.delta_forms == (False, True)
        for jm, tm in zip(jnode.id_maps, node.id_maps):
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        for jg, tg in zip(jnode.groups, node.groups):
            jl, tl = jax.tree_util.tree_leaves(jg), tree_leaves(tg)
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                assert b.shape[1] == 2           # (L, G+1, ...)
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_foldfree_bank_build_equals_jax(arch):
    """Fold-free QuanTA tenants bank bare: one delta-form group of the two
    fold-free tenants (rows: neutral, f0, f1; T and S each) beside the
    LoRA group, the same leaves and id_maps as the JAX bank bit for
    bit."""
    _, params = _jax_model(arch)
    jbank = JBank.build(params, _jax_tenants(arch, "foldfree"))
    tparams, tenants = _port_tenants(arch, "foldfree")
    bank = AdapterBank.build(tparams, tenants)
    assert bank.names == jbank.names == ("f0", "f1", "lo")
    assert bank.nbytes == sum(
        np.asarray(leaf).nbytes for leaf in jax.tree_util.tree_leaves(
            jbank.tree))
    jflat, tflat = flatten_paths(jbank.tree), flatten_paths(bank.tree)
    assert sorted(jflat) == sorted(tflat) and len(tflat) == 2
    for path, jnode in jflat.items():
        node = tflat[path]
        assert node.delta_forms == jnode.delta_forms == (True, True)
        assert node.groups[0].fold_free
        assert [m.tolist() for m in node.id_maps] == [[0, 1, 2, 0],
                                                      [0, 0, 0, 1]]
        for jm, tm in zip(jnode.id_maps, node.id_maps):
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        for jg, tg, rows in zip(jnode.groups, node.groups, (3, 2)):
            jl, tl = jax.tree_util.tree_leaves(jg), tree_leaves(tg)
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                assert b.shape[1] == rows        # (L, G+1, ...)
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("arch,case", [
    ("llama2-7b-proxy", "dense"), ("llama2-7b-proxy", "paged tight"),
    ("qwen2-0.5b", "dense")])
def test_foldfree_bank_engine_matches_jax_and_single_tenants(arch, case,
                                                             backend):
    """Fold-free QuanTA and LoRA tenants and the base in one batch: the
    JAX bank engine's greedy tokens and each tenant's single-tenant
    (fold-free) engine's."""
    want, j_preempt = _jax_bank_run(arch, "foldfree", case)
    tparams, tenants = _port_tenants(arch, "foldfree")
    bank = AdapterBank.build(tparams, tenants)
    assigns = _assigns(tenants)
    eng = _port_engine(arch, tparams, backend, adapters=bank,
                       **CACHES[case])
    got = _run(eng, Request, assigns, True)
    assert got == want
    assert eng.stats["preemptions"] == j_preempt
    assert (j_preempt > 0) == (case == "paged tight")
    for name in ("f0", "f1", "lo", None):
        single = _single_tenant(arch, "foldfree", backend, name, assigns)
        for uid, out in single.items():
            assert got[uid][:MAX_NEW] == out, (uid, name)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("case", list(CACHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_bank_engine_matches_jax_and_single_tenants(arch, case,
                                                          backend):
    want, j_preempt = _jax_bank_run(arch, "mixed", case)
    tparams, tenants = _port_tenants(arch)
    bank = AdapterBank.build(tparams, tenants)
    assigns = _assigns(tenants)
    eng = _port_engine(arch, tparams, backend, adapters=bank,
                       **CACHES[case])
    got = _run(eng, Request, assigns, True)
    assert got == want
    assert eng.stats["preemptions"] == j_preempt
    assert (j_preempt > 0) == (case == "paged tight")
    assert eng.stats["adapter_tenants"] == 2
    assert eng.stats["adapter_bytes"] == bank.nbytes > 0
    assert not eng._adapter_ids.any()            # freed slots decode as base
    # each tenant on its own engine, over the dense cache: a request that
    # is preempted re-prefills and takes one token past its budget before
    # it is retired, in the JAX engine as here, so its first MAX_NEW tokens
    # are compared
    for name in ("qa", "lo", None):
        single = _single_tenant(arch, "mixed", backend, name, assigns)
        for uid, out in single.items():
            assert got[uid][:MAX_NEW] == out, (uid, name)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_heterogeneous_ranks_dora_dota_krona_groups(backend):
    """LoRA ranks 4 and 8 land in separate groups; DoRA and DoTA take the
    where-selected path, KronA the gathered delta."""
    arch = "qwen2-0.5b"
    want, _ = _jax_bank_run(arch, "hetero", "dense")
    tparams, tenants = _port_tenants(arch, "hetero")
    bank = AdapterBank.build(tparams, tenants)
    node = bank.tree["layers"]["attn"]["q_proj"]
    assert len(node.groups) == 5
    assert node.delta_forms == (True, True, False, False, True)
    assigns = _assigns(tenants)
    got = _run(_port_engine(arch, tparams, backend, adapters=bank),
               Request, assigns, True)
    assert got == want
    for name in tenants:
        single = _single_tenant(arch, "hetero", backend, name, assigns)
        for uid, out in single.items():
            assert got[uid] == out, (uid, name)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_nf4_base_lora_bank_matches_jax(backend):
    """An NF4 base under a LoRA-only bank: the quantized base product,
    then the gathered LoRA delta without the base."""
    arch = "llama2-7b-proxy"
    model, params = _jax_model(arch)
    lora = {n: e for n, e in _jax_tenants(arch, "hetero").items()
            if n in ("r4", "r8")}
    eng = JEngine(model, params, adapters=JBank.build(params, lora),
                  n_slots=3, max_len=64, base_quant="nf4")
    want = _run(eng, JRequest, _assigns(lora), True)
    tparams, tenants = _port_tenants(arch, "hetero")
    bank = AdapterBank.build(tparams, {n: tenants[n] for n in lora})
    eng = _port_engine(arch, tparams, backend, adapters=bank,
                       base_quant="nf4")
    assert _run(eng, Request, _assigns(lora), True) == want
    assert eng.stats["base_quant"] == "nf4"


# --------------------------------------------------------- validation
def test_bank_validation_errors():
    arch = "qwen2-0.5b"
    tparams, tenants = _port_tenants(arch)
    _, qset = tenants["qa"]
    with pytest.raises(ValueError, match="folds the frozen copy"):
        AdapterBank.build(tparams, {"qa": qset})
    with pytest.raises(TypeError, match="AdapterSet"):
        AdapterBank.build(tparams, {"x": {"layers": {}}})
    bank = AdapterBank.build(tparams, tenants)
    assert bank.id_of(None) == 0
    assert bank.id_of("qa") == 1 and bank.id_of("lo") == 2
    with pytest.raises(KeyError, match="unknown adapter"):
        bank.id_of("nope")
    eng = _port_engine(arch, tparams, "reference", adapters=bank)
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.submit(Request(uid=0, prompt=[1, 2]), adapter="nope")
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.submit(Request(uid=1, prompt=[1, 2], adapter="nope"))
    # naming a tenant on an engine without a bank fails at submit and
    # leaves the request as it was
    plain = _port_engine(arch, tparams, "reference")
    rejected = Request(uid=0, prompt=[1, 2])
    with pytest.raises(ValueError, match="no AdapterBank"):
        plain.submit(rejected, adapter="qa")
    assert rejected.adapter is None
    plain.submit(rejected)
    with pytest.raises(ValueError, match="either peft"):
        _port_engine(arch, tparams, "reference", peft=tenants["lo"],
                     adapters=bank)
    # a bank cannot be applied without per-request ids
    model = build_model(get_smoke(arch), device="cpu")
    with pytest.raises(ValueError, match="adapter_ids"):
        model.forward(tparams, {"tokens": torch.ones((1, 3), dtype=int)},
                      peft=bank)
    with pytest.raises(ValueError, match="adapter_ids"):
        model.prefill(tparams, bank, {"tokens": torch.ones((1, 3),
                                                           dtype=int)})


def test_banked_adapter_layer_view_and_ids():
    """``subtree`` looks the global ids up in the id_maps; ``layer(i)``
    takes one layer of every group and keeps the per-slot rows."""
    tparams, tenants = _port_tenants("qwen2-0.5b")
    bank = AdapterBank.build(tparams, tenants)
    sub = bank.subtree("layers", torch.tensor([2, 0, 1, 2]))
    leaf = sub["attn"]["q_proj"]
    assert isinstance(leaf, BankedAdapter) and leaf.stacked
    assert [t.tolist() for t in leaf.ids] == [[0, 0, 1, 0], [1, 0, 0, 1]]
    one = leaf.layer(1)
    assert not one.stacked and one.ids == leaf.ids
    for g, g1 in zip(leaf.groups, one.groups):
        for t, t1 in zip(tree_leaves(g), tree_leaves(g1)):
            assert torch.equal(t[1], t1)


def test_port_attach_builds_bankable_tenants():
    """Tenants attached by the port itself (every method) bank and serve;
    at attach every non-QuanTA tenant is exactly the base model."""
    arch = "llama2-7b-proxy"
    model = build_model(get_smoke(arch), device="cpu")
    params = model.init(0)
    tenants = {}
    for i, method in enumerate(("lora", "dora", "dota", "krona")):
        _, aset = attach(i + 1, params, PeftConfig(
            method=method, rank=4, n_axes=3, krona_a=8), device="cpu")
        tenants[method] = aset
    tenants["quanta"] = attach(9, params, PeftConfig(n_axes=4),
                               device="cpu")
    bank = AdapterBank.build(params, tenants)
    eng = ServingEngine(model, params, adapters=bank, n_slots=3, max_len=64,
                        device="cpu")
    assigns = _assigns(tenants)
    got = _run(eng, Request, assigns, True)
    base = _run(ServingEngine(model, params, n_slots=3, max_len=64,
                              device="cpu"), Request, assigns, False)
    assert got == base
