"""The port's mesh layer without a process group, held against the JAX
package on ``make_abstract_mesh``: for every arch at FULL shapes the
param (train and decode), cache (dense, ``seq_shard``, paged with
``pool_data_shards``), batch and train-state specs equal the JAX
``NamedSharding.spec`` leaf for leaf on the ``(16, 16)``, ``(2, 16, 16)``
and ``(2, 4)`` meshes; the bank rules (``bank_dp``) on a SMOKE bank; the
meshes' axes, ``dp_axes`` and ``bubble_fraction``; ``build_programs`` /
``build_state_specs`` on ``meta`` against JAX's ``eval_shape``; and the
``data_shards=2`` arenas of ``PagedCacheView`` against JAX's.

Specs compare after one normalization: trailing ``None`` entries drop and
a one-axis tuple reads as the axis (``P(("data",))`` is ``P("data")``)."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import (
    ARCH_IDS as J_ARCH_IDS, get_config as j_get_config,
    get_peft as j_get_peft, get_shapes as j_get_shapes,
    get_smoke as j_get_smoke,
)
from repro.core.bank import AdapterBank as JBank
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.launch import mesh as j_mesh
from repro.launch import shardings as j_sh
from repro.launch import steps as j_steps
from repro.models import build_model as j_build_model
from repro.models.api import input_specs as j_input_specs
from repro.serve.paging import PagedCacheView as JView
from repro.train.pipeline import bubble_fraction as j_bubble
from repro_torch import interop
from repro_torch.configs import (
    ARCH_IDS, get_config, get_peft, get_shapes, get_smoke,
)
from repro_torch.core.bank import AdapterBank
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import shardings as t_sh
from repro_torch.launch.steps import build_programs
from repro_torch.models import build_model, param_specs
from repro_torch.serve.paging import PagedCacheView
from repro_torch.train.pipeline import bubble_fraction

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
# the decode cell's slots (every arch's decode shapes have 128) and a
# paged pool over 4096 tokens a slot
SLOTS, MAX_LEN, PAGED_LEN, BLOCK = 128, 32768, 4096, 16


def _norm(spec):
    out = [e[0] if isinstance(e, tuple) and len(e) == 1
           else tuple(e) if isinstance(e, (tuple, list)) else e
           for e in tuple(spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _key(k):
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))


def _jax_specs(tree):
    """``{path: spec}`` of a JAX sharding tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key(k) for k in path): _norm(s.spec)
            for path, s in flat}


def _port_specs(tree):
    """``{path: spec}`` of a port spec tree."""
    out = {}
    _walk_specs(tree, (), out)
    return out


def _walk_specs(tree, path, out):
    import dataclasses

    if isinstance(tree, t_sh.PartitionSpec):
        out["/".join(path)] = _norm(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _walk_specs(v, path + (str(k),), out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _walk_specs(v, path + (str(i),), out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _walk_specs(getattr(tree, f.name), path + (f.name,), out)


def _meshes(name):
    shape, names = MESHES[name]
    return (j_mesh.make_abstract_mesh(shape, names),
            t_mesh.make_abstract_mesh(shape, names))


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    cfg = j_get_config(arch)
    model = j_build_model(cfg)
    return cfg, model, jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    cfg = get_config(arch)
    return cfg, build_model(cfg, device="meta"), param_specs(cfg)


def test_arch_ids_match():
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS)


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(J_ARCH_IDS))
def test_param_and_cache_specs_match_jax(arch, mesh):
    """Params (train and decode), dense caches (and ``seq_shard``), paged
    pools gated on their arenas, and the decode batch, at FULL shapes."""
    jm, tm = _meshes(mesh)
    jcfg, jmodel, jparams = _jax_model(arch)
    tcfg, tmodel, tparams = _port_model(arch)
    for decode in (False, True):
        want = _jax_specs(j_sh.param_shardings(jcfg, jm, jparams,
                                               decode=decode))
        got = _port_specs(t_sh.param_shardings(tcfg, tm, tparams,
                                               decode=decode))
        assert got == want, (arch, mesh, decode)
    jcache = jax.eval_shape(lambda: jmodel.init_cache(SLOTS, MAX_LEN))
    tcache = tmodel.init_cache(SLOTS, MAX_LEN, device="meta")
    for seq in (False, True):
        assert _port_specs(t_sh.cache_shardings(
            tcfg, tm, tcache, seq_shard=seq)) == _jax_specs(
            j_sh.cache_shardings(jcfg, jm, jcache, seq_shard=seq))
    dp = int(np.prod([dict(jm.shape)[a] for a in j_mesh.dp_axes(jm)]))
    jv = JView(jmodel, SLOTS, PAGED_LEN, BLOCK, data_shards=dp)
    tv = PagedCacheView(tmodel, SLOTS, PAGED_LEN, BLOCK, data_shards=dp)
    for shards in (None, dp, 1):
        want = _jax_specs(j_sh.cache_shardings(
            jcfg, jm, jv.struct(), spec=jv.serve_spec, paged=True,
            pool_data_shards=shards))
        got = _port_specs(t_sh.cache_shardings(
            tcfg, tm, tv.meta_struct(), spec=tv.serve_spec, paged=True,
            pool_data_shards=shards))
        assert got == want, (arch, mesh, shards)
    decode = next(s for s in j_get_shapes(arch) if s.kind == "decode")
    tdecode = next(s for s in get_shapes(arch) if s.kind == "decode")
    assert _port_specs(t_sh.batch_shardings(tm, {
        k: v for k, v in _port_inputs(tcfg, tdecode).items()})) == \
        _jax_specs(j_sh.batch_shardings(jm, j_input_specs(jcfg, decode)))


def _port_inputs(cfg, shape):
    from repro_torch.models.api import input_specs

    return input_specs(cfg, shape)


@functools.lru_cache(maxsize=None)
def _states(arch):
    """Each package's adapted train state of ``arch``, built from the
    param shapes above (``build_state_specs`` itself is held below)."""
    from repro.train.loop import TrainState as JTrainState
    from repro_torch.core.peft import attach
    from repro_torch.launch.steps import default_optimizer
    from repro_torch.train import TrainState

    jstate = jax.eval_shape(lambda p: JTrainState.create(
        *j_attach(jax.random.PRNGKey(0), p, j_get_peft(arch)),
        j_steps.default_optimizer()), _jax_model(arch)[2])
    tstate = TrainState.create(
        *attach(0, _port_model(arch)[2], get_peft(arch), device="meta"),
        default_optimizer())
    return jstate, tstate


@pytest.mark.parametrize("arch", list(J_ARCH_IDS))
def test_state_specs_match_jax(arch):
    """``state_shardings`` of each arch's adapted train state (base params
    per the rules, the rest replicated) on the three meshes."""
    jstate, tstate = _states(arch)
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        want = _jax_specs(j_sh.state_shardings(j_get_config(arch), jm,
                                               jstate))
        got = _port_specs(t_sh.state_shardings(get_config(arch), tm,
                                               tstate))
        assert got == want, (arch, mesh)


@functools.lru_cache(maxsize=None)
def _banks():
    """A JAX bank and its port: LoRA tenants of ranks 4 and 8 (two
    structure groups) over the qwen2-0.5b SMOKE base, zeros of the
    ``eval_shape`` shapes (the rules read shapes alone)."""
    def zeros(tree):
        return jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), tree)

    params = zeros(jax.eval_shape(
        j_build_model(j_get_smoke("qwen2-0.5b")).init, jax.random.PRNGKey(0)))
    sets = {f"r{r}": zeros(jax.eval_shape(lambda p, r=r: j_attach(
        jax.random.PRNGKey(r), p, JPeftConfig(method="lora", rank=r))[1],
        params)) for r in (4, 8)}
    jb = JBank.build(params, sets)
    tparams = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    tb = AdapterBank.build(tparams, {
        n: interop.adapter_set_from_numpy(a, "cpu") for n, a in sets.items()})
    return jb, tb, sets["r4"]


def test_peft_specs_match_jax():
    """Adapters replicated; ``bank_dp`` splits a bank's bank axis over the
    DP axes where it divides (id maps replicated); an adapter set ignores
    ``bank_dp``."""
    jb, tb, jset = _banks()
    tset = interop.adapter_set_from_numpy(jset, "cpu")
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for bank_dp in (False, True):
            want = _jax_specs(j_sh.peft_shardings(jm, jb, bank_dp=bank_dp))
            got = _port_specs(t_sh.peft_shardings(tm, tb, bank_dp=bank_dp))
            assert got == want, (mesh, bank_dp)
        assert _port_specs(t_sh.peft_shardings(tm, tset, bank_dp=True)) \
            == _jax_specs(j_sh.peft_shardings(jm, jset, bank_dp=True))
    split = [s for s in _port_specs(t_sh.peft_shardings(
        _meshes("2x4")[1], tb, bank_dp=True)).values() if s]
    assert split and all("data" in s for s in split)


def test_meshes_dp_axes_and_bubble_match_jax():
    for name, (shape, names) in MESHES.items():
        jm, tm = _meshes(name)
        assert dict(tm.shape) == dict(jm.shape)
        assert tuple(tm.axis_names) == tuple(jm.axis_names)
        assert t_mesh.dp_axes(tm) == j_mesh.dp_axes(jm)
    for m, p in ((6, 4), (1, 1), (16, 8), (3, 2)):
        assert bubble_fraction(m, p) == j_bubble(m, p)
    # a host mesh is the world as it stands: 2 ranks need a process group
    # of 2 (a world of one is made only for 1 x 1), and without a card
    # the CPU is used only when asked for
    with pytest.raises(ValueError, match="2 ranks"):
        t_mesh.make_host_mesh(2, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_mesh.make_host_mesh(1, 1)


# ---------------------------------------------------------- the programs
def _shape_dtype(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_programs_on_meta_match_jax(kind):
    arch = "qwen2-0.5b"
    jshape = next(s for s in j_get_shapes(arch) if s.kind == kind)
    tshape = next(s for s in get_shapes(arch) if s.kind == kind)
    jp = j_steps.build_programs(j_get_config(arch), jshape)
    tp = build_programs(get_config(arch), tshape, device="meta")
    assert tp.kind == jp.kind == kind
    assert {k: _shape_dtype(v) for k, v in tp.batch_specs.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jp.batch_specs.items()}
    if kind == "decode":
        assert {k: _shape_dtype(v) for k, v in tp.cache_specs().items()} \
            == {k: (tuple(v.shape), str(v.dtype))
                for k, v in jp.cache_specs().items()}
    if kind == "train":
        from repro_torch.checkpoint import tree_flatten_with_paths

        js = jp.state_specs(j_get_peft(arch))
        ts = tp.state_specs(get_peft(arch))
        tpaths, tleaves = tree_flatten_with_paths(ts)
        jflat = jax.tree_util.tree_flatten_with_path(js)[0]
        assert len(jflat) == len(tleaves)
        assert all(t.device.type == "meta" for t in tleaves
                   if isinstance(t, torch.Tensor))
        jd = {"/".join(_key(k) for k in p): (tuple(v.shape), str(v.dtype))
              for p, v in jflat}
        td = {p.replace("/.", "/").lstrip("."): (
            _shape_dtype(v) if isinstance(v, torch.Tensor) else ((), "int32"))
            for p, v in zip(tpaths, tleaves)}
        assert td == jd


# -------------------------------------------------------------- arenas
def test_data_shard_arenas_match_jax():
    """Mirrors ``test_paged_view_arena_partitioning``: two arenas, each
    with its own null row, allocations from the slot's own arena, the
    same tables, padding, stats and rounding as the JAX view, and the
    uneven split's ``ValueError``."""
    jm = j_build_model(j_get_smoke("qwen2-0.5b"))
    tm = build_model(get_smoke("qwen2-0.5b"), device="cpu")
    jv = JView(jm, n_slots=4, max_len=64, block_size=8, data_shards=2)
    tv = PagedCacheView(tm, n_slots=4, max_len=64, block_size=8,
                        data_shards=2)
    a = tv.arena_size
    assert (tv.n_blocks, a) == (jv.n_blocks, jv.arena_size) == (34, 17)
    assert [tv.shard_of(s) for s in range(4)] == [0, 0, 1, 1]
    assert tv.null_of(1) == jv.null_of(1) == a
    assert tv.max_request_blocks == jv.max_request_blocks == a - 1
    rng = np.random.default_rng(0)
    for _ in range(40):
        slot = int(rng.integers(0, 4))
        if rng.random() < 0.3:
            tv.release(slot)
            jv.release(slot)
            continue
        n = int(rng.integers(1, 64))
        ok = tv.can_admit(n, slot)
        assert ok == jv.can_admit(n, slot)
        try:
            jv.ensure(slot, n)
        except MemoryError:
            with pytest.raises(MemoryError):
                tv.ensure(slot, n)
            continue
        tv.ensure(slot, n)
        t = tv.host_tables()
        np.testing.assert_array_equal(t, np.asarray(jv.device_tables()))
        lo, hi = tv.shard_of(slot) * a, (tv.shard_of(slot) + 1) * a
        assert ((t[slot] >= lo) & (t[slot] < hi)).all()
        assert tv.stats() == {k: v for k, v in jv.stats().items()
                              if k in tv.stats()} | {
            "cache_bytes_allocated": tv.stats()["cache_bytes_allocated"],
            "kv_quant": None}
    np.testing.assert_array_equal(tv.wave_tables(np.array([3, 0]), 5),
                                  jv.wave_tables(np.array([3, 0]), 5))
    odd = PagedCacheView(tm, n_slots=4, max_len=64, block_size=8,
                         n_blocks=7, data_shards=2)
    assert (odd.n_blocks, odd.arena_size) == (8, 4)
    with pytest.raises(ValueError, match="divide evenly"):
        PagedCacheView(tm, n_slots=3, max_len=64, block_size=8,
                       data_shards=2)
