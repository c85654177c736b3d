"""The port's adapter lifecycle (``serve/adapter_pool.py``): the row
allocator, the tenant registry and the fixed-capacity resident pool, held
against the JAX package's (same rows, same ids, same errors), and serving
through a pool that churns -- tenants loaded, evicted and reloaded while
requests defer and preempt -- gives the tokens of cold single-tenant
engines and of the JAX pool engine (qwen2-0.5b SMOKE, folded QuanTA, LoRA
and DoTA tenants made by the JAX package and carried over as numpy), also
for fold-free QuanTA tenants, whose resident cost is their factor rows
(the JAX suite's fold-free byte test)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro.serve import (
    AdapterPool as JPool, AdapterStore as JStore, Request as JRequest,
    RowAllocator as JRowAllocator, ServingEngine as JEngine,
)
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.core.adapters import tree_leaves
from repro_torch.models import build_model
from repro_torch.serve import (
    AdapterPool, AdapterStore, Request, RowAllocator, ServingEngine,
)

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

ARCH = "qwen2-0.5b"
PROMPTS = [[5, 9, 13], [40, 2], [7, 7, 7, 7, 21, 3, 99], [100, 101],
           [1], [13, 5, 88, 4, 2], [250, 3, 17], [9] * 11]
MAX_NEW = 5


# ------------------------------------------------------------- allocator
def test_row_allocator_basics():
    alloc = RowAllocator(3)
    assert alloc.available == 3 and alloc.in_use == 0
    rows = [alloc.alloc() for _ in range(3)]
    assert rows == [1, 2, 3]          # row 0 is the neutral, never issued
    with pytest.raises(MemoryError, match="bank full"):
        alloc.alloc()
    alloc.free(2)
    assert alloc.alloc() == 2
    with pytest.raises(ValueError, match="double free"):
        alloc.free(3) or alloc.free(3)
    with pytest.raises(ValueError, match="invalid bank row"):
        alloc.free(0)
    with pytest.raises(ValueError, match="invalid bank row"):
        alloc.free(4)
    assert alloc.peak_in_use == 3
    with pytest.raises(ValueError, match="at least one"):
        RowAllocator(0)


@pytest.mark.parametrize("seed", [0, 1])
def test_row_allocator_matches_jax_and_never_double_assigns(seed):
    """The same random alloc/free trace hands out the same rows as the JAX
    allocator, never a held row or the neutral, and keeps the gauges."""
    ta, ja = RowAllocator(9), JRowAllocator(9)
    held = set()
    rng = np.random.default_rng(seed)
    for _ in range(300):
        if held and rng.random() < 0.45:
            victim = int(rng.choice(sorted(held)))
            ta.free(victim)
            ja.free(victim)
            held.discard(victim)
        elif ta.available:
            row = ta.alloc()
            assert row == ja.alloc()
            assert row not in held and 0 < row <= 9
            held.add(row)
        assert (ta.in_use, ta.available, ta.peak_in_use) == (
            ja.in_use, ja.available, ja.peak_in_use) and ta.in_use == len(held)
    for row in sorted(held):
        ta.free(row)
    assert ta.in_use == 0 and ta.available == 9


if HAVE_HYPOTHESIS:
    @settings(max_examples=30, deadline=None)
    @given(cap=st.integers(min_value=1, max_value=12),
           ops=st.lists(st.integers(min_value=0, max_value=2 ** 16),
                        max_size=60))
    def test_row_allocator_trace_property(cap, ops):
        """Any alloc/free interleaving: no row handed out twice, counts
        kept, a drain returns every row."""
        alloc = RowAllocator(cap)
        held = []
        for op in ops:
            if held and op % 2:
                alloc.free(held.pop(op % len(held)))
            elif alloc.available:
                row = alloc.alloc()
                assert row not in held
                held.append(row)
            assert alloc.in_use == len(held)
        for row in held:
            alloc.free(row)
        assert alloc.available == cap


# ------------------------------------------------------------- tenants
def _noise(tree, seed, scale=0.15):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(scale * rs.standard_normal(t.shape),
                                  t.dtype), tree)


@functools.lru_cache(maxsize=None)
def _jax_side():
    """The JAX model, its params and tenants: folded QuanTA (the attach
    pair), LoRA l0 and l1 (one structure group), LoRA rank 8, DoTA, and
    fold-free QuanTA f0, f1, f2 (one structure group)."""
    model = j_build_model(j_get_smoke(ARCH))
    params = model.init(jax.random.PRNGKey(0))
    qbase, qset = j_attach(jax.random.PRNGKey(1), params, JPeftConfig(
        method="quanta", n_axes=3, noise_scale=0.3))
    tenants = {"qa": (qbase, qset)}
    for i in range(3):
        _, fset = j_attach(jax.random.PRNGKey(20 + i), params, JPeftConfig(
            method="quanta", n_axes=3, noise_scale=0.3, fold=False))
        tenants[f"f{i}"] = _noise(fset, 30 + i, 0.1)
    for i, (name, cfg) in enumerate((
            ("l0", JPeftConfig(method="lora", rank=4)),
            ("l1", JPeftConfig(method="lora", rank=4)),
            ("r8", JPeftConfig(method="lora", rank=8)),
            ("dt", JPeftConfig(method="dota", rank=2, n_axes=3)))):
        _, aset = j_attach(jax.random.PRNGKey(2 + i), params, cfg)
        tenants[name] = _noise(aset, 10 + i, 0.05 if name == "dt" else 0.15)
    return model, params, tenants


@functools.lru_cache(maxsize=None)
def _port_side():
    _, params, tenants = _jax_side()
    return (interop.params_from_numpy(params, "cpu"),
            {n: interop.tenant_from_numpy(e, "cpu")
             for n, e in tenants.items()})


def _store(names, max_tenants=8):
    _, tenants = _port_side()
    store = AdapterStore(max_tenants=max_tenants)
    for n in names:
        store.register(n, tenants[n])
    return store


def _serve(params, assigns, peft=None, adapters=None, backend="pallas",
           n_slots=3, **kw):
    model = build_model(get_smoke(ARCH).replace(
        attn_backend=backend, peft_backend=backend), device="cpu")
    engine = ServingEngine(model, params, peft, adapters=adapters,
                           n_slots=n_slots, max_len=64, device="cpu", **kw)
    reqs = []
    for uid, prompt, tenant in assigns:
        r = Request(uid=uid, prompt=list(prompt), max_new_tokens=MAX_NEW)
        engine.submit(r, adapter=tenant if adapters is not None else None)
        reqs.append(r)
    engine.run()
    assert all(r.done for r in reqs)
    return {r.uid: r.output for r in reqs}, engine


def _cold(name, assigns, backend="pallas"):
    """One tenant's requests on a cold single-tenant engine."""
    params, tenants = _port_side()
    entry = tenants.get(name)
    p, peft = entry if isinstance(entry, tuple) else (params, entry)
    return _serve(p, [a for a in assigns if a[2] == name], peft=peft,
                  backend=backend)[0]


# ------------------------------------------------------------ registry
def test_store_validation():
    params, tenants = _port_side()
    store = AdapterStore(max_tenants=2)
    assert store.register("a", tenants["l0"]) == 1
    with pytest.raises(ValueError, match="already registered"):
        store.register("a", tenants["l0"])
    assert store.register("b", tenants["l1"]) == 2
    with pytest.raises(ValueError, match="registry full"):
        store.register("c", tenants["r8"])
    with pytest.raises(KeyError, match="unknown adapter"):
        store.get("zzz")
    with pytest.raises(KeyError, match="unknown adapter"):
        store.id_of("zzz")
    assert store.id_of(None) == 0
    assert store.id_of("a") == 1 and store.id_of("b") == 2
    assert store.names == ("a", "b") and store.num_tenants == 2
    assert store.nbytes == sum(
        t.numel() * 4 for n in ("l0", "l1")
        for a in tenants[n].flat().values() for t in tree_leaves(a))
    fresh = AdapterStore(max_tenants=4)
    with pytest.raises(ValueError, match="folds the frozen copy"):
        fresh.register("q", tenants["qa"][1])
    fresh.register("q", tenants["qa"])        # the pair is fine
    with pytest.raises(ValueError, match="max_tenants"):
        AdapterStore(max_tenants=0)


def test_pool_build_validation():
    params, _ = _port_side()
    store = AdapterStore(max_tenants=4)
    with pytest.raises(ValueError, match="at least one tenant"):
        AdapterPool.build(params, store, capacity=2)
    store.register("a", _port_side()[1]["l0"])
    with pytest.raises(ValueError, match="capacity"):
        AdapterPool.build(params, store, capacity=0)


def test_pool_layout_matches_jax_pool():
    """Groups per path, rows per group and id_maps as the JAX pool lays
    them out, and the same resident and registry bytes.  The leaves agree
    to 1e-6 relative: the DoTA group's neutral magnitudes are column norms,
    which the two libraries sum in another order (a few ulps); every other
    leaf is equal."""
    _, jparams, jtenants = _jax_side()
    jstore = JStore(max_tenants=8)
    for n in ("qa", "l0", "l1", "dt"):
        jstore.register(n, jtenants[n])
    jpool = JPool.build(jparams, jstore, capacity=2)
    params, _ = _port_side()
    pool = AdapterPool.build(params, _store(("qa", "l0", "l1", "dt")),
                             capacity=2)
    assert pool.resident_nbytes() == jpool.resident_nbytes()
    assert pool.store.nbytes == jstore.nbytes
    for path in ("layers/attn/q_proj", "layers/attn/v_proj"):
        node, jnode = pool._path_node(path), jpool._path_node(path)
        assert node.delta_forms == jnode.delta_forms == (False, True, False)
        for g, jg in zip(node.groups, jnode.groups):
            for t, j in zip(tree_leaves(g), jax.tree_util.tree_leaves(jg)):
                assert t.shape == j.shape and t.shape[1] == 3
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-6, atol=0)
    for name in ("l0", "dt", "qa"):
        assert pool.acquire(name) and jpool.acquire(name)
    for path in ("layers/attn/q_proj", "layers/attn/v_proj"):
        for m, jm in zip(pool._path_node(path).id_maps,
                         jpool._path_node(path).id_maps):
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


# ------------------------------------------------------------ lifecycle
def test_pool_lifecycle_lru_pins_and_late_registration():
    params, tenants = _port_side()
    store = AdapterStore(max_tenants=8)
    for i, src in enumerate(("l0", "l1", "l0", "l1")):
        store.register(f"t{i}", tenants[src])
    pool = AdapterPool.build(params, store, capacity=2)
    bytes0 = pool.resident_nbytes()
    ptrs0 = [t.data_ptr() for t in tree_leaves(
        pool._path_node("layers/attn/q_proj").groups)]

    assert pool.load("t0") and pool.load("t1")
    assert pool.num_resident == 2 and pool.is_resident("t0")
    # t2 evicts the least recently used unpinned tenant (t0)
    assert pool.acquire("t2")
    assert not pool.is_resident("t0") and pool.is_resident("t1")
    assert pool.evictions == 1 and pool.loads == 3
    # pinned tenants refuse eviction...
    assert pool.pins_of("t2") == 1
    assert pool.evict("t2") is False and pool.evict_denied == 1
    # ...and with every row pinned, acquire defers
    assert pool.acquire("t1")
    assert pool.acquire("t3") is False and pool.acquire_denied == 1
    pool.release("t1")
    assert pool.acquire("t3") and not pool.is_resident("t1")
    pool.release("t2")
    pool.release("t3")
    assert pool.evict("t3") is True and pool.evict("t3") is False
    with pytest.raises(ValueError, match="without a matching acquire"):
        pool.release("t2") or pool.release("t2")
    assert pool.acquire(None) is True         # the base model: always ready
    pool.release(None)

    # swaps copy in place: the bank tensors and bytes never change
    assert pool.resident_nbytes() == bytes0
    assert ptrs0 == [t.data_ptr() for t in tree_leaves(
        pool._path_node("layers/attn/q_proj").groups)]

    # a late tenant with a matching structure loads; a new structure
    # (rank 8: a new group) needs a rebuild
    store.register("late", tenants["l1"])
    assert pool.load("late")
    store.register("r8", tenants["r8"])
    with pytest.raises(ValueError, match="matching no resident group"):
        pool.load("r8")
    stats = pool.stats()
    assert stats["adapter_capacity"] == 2
    assert stats["adapter_bytes_resident"] == bytes0
    assert stats["adapter_bytes_registry"] == store.nbytes
    assert stats["adapter_swap_p50"] >= 0.0


def test_evicted_rows_are_unreachable_and_reload_exactly():
    """After an evict the tenant's id maps to the neutral row; a reload
    into another row carries its factors bit for bit."""
    params, tenants = _port_side()
    pool = AdapterPool.build(params, _store(("l0", "l1")), capacity=1)
    path = "layers/attn/q_proj"
    assert pool.load("l0")
    node = pool._path_node(path)
    lora = tenants["l0"].flat()[path]
    assert torch.equal(node.groups[0].a[:, 1], lora.a)
    assert node.id_maps[0].tolist() == [0, 1, 0] + [0] * 6
    assert pool.load("l1")                     # evicts l0
    assert node.id_maps[0].tolist() == [0, 0, 1] + [0] * 6
    assert torch.equal(node.groups[0].a[:, 1],
                       tenants["l1"].flat()[path].a)
    assert not node.groups[0].a[:, 0].any()    # row 0 stays neutral


# -------------------------------------------------------------- serving
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_churn_matches_cold_engines(cache):
    """Folded QuanTA, two same-structure LoRA tenants and DoTA churning
    through a capacity-1 pool (the two LoRA tenants share one row):
    token for token the cold single-tenant engines, with loads and
    evictions on the way, and no pin left behind."""
    params, _ = _port_side()
    names = ("qa", "l0", "dt", "l1")
    pool = AdapterPool.build(params, _store(names), capacity=1)
    rotation = list(names) + [None]
    assigns = [(i, p, rotation[i % 5]) for i, p in enumerate(PROMPTS)]
    kw = dict(cache="paged", block_size=8) if cache == "paged" else {}
    outs, engine = _serve(params, assigns, adapters=pool, **kw)
    st = engine.stats
    assert st["adapter_loads"] >= 5 and st["adapter_evictions"] >= 1
    assert st["adapter_bytes"] == pool.resident_nbytes()
    assert st["adapter_bytes_registry"] == pool.store.nbytes
    assert st["adapter_tenants"] == 4
    assert all(pool.pins_of(n) == 0 for n in names), "leaked a pin"
    for name in rotation:
        for uid, out in _cold(name, assigns).items():
            assert outs[uid] == out, (uid, name)
    if cache == "dense":
        # the JAX pool engine serves the same churn to the same tokens
        jmodel, jparams, jtenants = _jax_side()
        jstore = JStore(max_tenants=8)
        for n in names:
            jstore.register(n, jtenants[n])
        jeng = JEngine(jmodel, jparams, adapters=JPool.build(
            jparams, jstore, capacity=1), n_slots=3, max_len=64)
        jreqs = []
        for uid, prompt, tenant in assigns:
            r = JRequest(uid=uid, prompt=list(prompt),
                         max_new_tokens=MAX_NEW)
            jeng.submit(r, adapter=tenant)
            jreqs.append(r)
        jeng.run()
        assert outs == {r.uid: r.output for r in jreqs}
        assert st["adapter_loads"] == jeng.stats["adapter_loads"]
        assert st["adapter_evictions"] == jeng.stats["adapter_evictions"]


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_foldfree_churn_matches_cold_engines_and_jax(backend):
    """Three fold-free QuanTA tenants (one structure group) and a LoRA
    tenant churning through a capacity-1 pool: token for token each
    tenant's cold single-tenant fold-free engine and the JAX pool
    engine, loads and evictions as JAX's."""
    params, _ = _port_side()
    names = ("f0", "f1", "l0", "f2")
    pool = AdapterPool.build(params, _store(names), capacity=1)
    rotation = list(names) + [None]
    assigns = [(i, p, rotation[i % 5]) for i, p in enumerate(PROMPTS)]
    outs, engine = _serve(params, assigns, adapters=pool, backend=backend)
    st = engine.stats
    assert st["adapter_loads"] >= 4 and st["adapter_evictions"] >= 2
    assert all(pool.pins_of(n) == 0 for n in names), "leaked a pin"
    for name in rotation:
        for uid, out in _cold(name, assigns, backend).items():
            assert outs[uid] == out, (uid, name)
    j_outs, j_loads, j_evictions = _jax_foldfree_churn(tuple(names))
    assert outs == j_outs
    assert st["adapter_loads"] == j_loads
    assert st["adapter_evictions"] == j_evictions


@functools.lru_cache(maxsize=None)
def _jax_foldfree_churn(names):
    """The JAX pool engine's tokens, loads and evictions for the churn
    above (the same for either port backend)."""
    rotation = list(names) + [None]
    jmodel, jparams, jtenants = _jax_side()
    jstore = JStore(max_tenants=8)
    for n in names:
        jstore.register(n, jtenants[n])
    jeng = JEngine(jmodel, jparams, adapters=JPool.build(
        jparams, jstore, capacity=1), n_slots=3, max_len=64)
    jreqs = []
    for i, prompt in enumerate(PROMPTS):
        r = JRequest(uid=i, prompt=list(prompt), max_new_tokens=MAX_NEW)
        jeng.submit(r, adapter=rotation[i % 5])
        jreqs.append(r)
    jeng.run()
    return ({r.uid: r.output for r in jreqs}, jeng.stats["adapter_loads"],
            jeng.stats["adapter_evictions"])


def test_foldfree_quanta_resident_bytes_are_factor_bytes():
    """The QuanTA paper's serving pitch: a fold-free tenant's resident
    cost is its factor rows -- each bank group holds ``capacity + 1``
    stacks of the factor tensors (T and S) and nothing dense; a folded
    tenant carries a dense ``(d_in, d_out)`` base a layer in its
    ``RebasedAdapter`` (the JAX suite's test, and the JAX pool's bytes)."""
    from repro_torch.core.adapters import tree_nbytes
    from repro_torch.core.peft import flatten_paths

    params, tenants = _port_side()
    store = AdapterStore(max_tenants=2)
    store.register("f0", tenants["f0"])
    capacity = 3
    pool = AdapterPool.build(params, store, capacity=capacity)
    flat_base = flatten_paths(params)
    folded = AdapterStore(max_tenants=1)
    folded.register("qa", tenants["qa"])
    for path, (adapter, _spec) in store.get("f0").items():
        assert adapter.fold_free
        factor_bytes = tree_nbytes(adapter)
        group_bytes = sum(tree_nbytes(g)
                          for g in pool._path_node(path).groups)
        assert group_bytes == (capacity + 1) * factor_bytes, path
        w0 = flat_base[path]
        dense = w0.numel() * w0.element_size()
        assert group_bytes < (capacity + 1) * dense, path
        rebased, _ = folded.get("qa")[path]
        assert tree_nbytes(rebased) == dense + tree_nbytes(rebased.inner)
    _, jparams, jtenants = _jax_side()
    jstore = JStore(max_tenants=2)
    jstore.register("f0", jtenants["f0"])
    jpool = JPool.build(jparams, jstore, capacity=capacity)
    assert pool.resident_nbytes() == jpool.resident_nbytes()
    assert store.nbytes == jstore.nbytes


def test_preemption_and_deferral_across_evict_reload():
    """Paged pool with few blocks and a capacity-1 adapter pool: requests
    defer while their group's only row is pinned, preempted requests
    requeue and re-acquire (reloading after an eviction), and the tokens
    equal an ample run's."""
    params, _ = _port_side()
    prompts = [[7 + i] * 8 for i in range(4)]
    assigns = [(i, p, ["l0", "l1", None, "l0"][i])
               for i, p in enumerate(prompts)]

    def run(capacity, n_blocks):
        pool = AdapterPool.build(params, _store(("l0", "l1"), 4),
                                 capacity=capacity)
        outs, engine = _serve(params, assigns, adapters=pool,
                              cache="paged", block_size=8,
                              n_blocks=n_blocks)
        return outs, engine.stats, pool

    ample, astats, _ = run(capacity=2, n_blocks=4 * 8 + 2)
    tight, tstats, tpool = run(capacity=1, n_blocks=3)
    assert astats["preemptions"] == 0
    assert tstats["preemptions"] > 0
    assert tstats["adapter_acquire_denied"] > 0
    assert tstats["adapter_evictions"] >= 1
    assert tstats["adapter_loads"] >= 3
    assert all(tpool.pins_of(n) == 0 for n in ("l0", "l1"))
    assert tight == ample
