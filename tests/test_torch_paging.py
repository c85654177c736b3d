"""The port's paged KV cache held against the JAX package: the block
allocator and ``PagedCacheView`` give the same blocks, tables, clamps,
null rows, stats and atomic out-of-blocks behaviour; the paged decode
kernels' plain versions match the JAX Pallas kernel in interpret mode
(bf16 rows and NF4/int8 codes, f32 at 3e-5, also over long extents,
blocks that do not divide 64 and windows down to 1); and the port's engine
over a
paged cache (rows, NF4/int8 KV codes, a pool small enough to preempt)
generates the JAX engine's greedy tokens exactly, on the llama2-7b-proxy
and qwen2-0.5b SMOKE configs."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import (
    PeftConfig as JPeftConfig, attach as j_attach, merge_all as j_merge_all,
)
from repro.core.quantize import quantize_kv as j_quantize_kv
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest, ServingEngine as JEngine
from repro.serve.paging import (
    BlockAllocator as JAllocator, PagedCacheView as JView,
)
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.peft import merge_all
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.serve import Request, ServingEngine
from repro_torch.serve.paging import (
    NULL_BLOCK, BlockAllocator, PagedCacheView,
)

# the JAX module (its package re-exports a function of the same name)
j_fa = importlib.import_module("repro.kernels.flash_attention")


# ------------------------------------------------------------- allocator
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_on_random_churn(seed):
    """The same alloc/free sequence hands out the same blocks, never
    double-assigns and never the null block, and keeps the same gauges."""
    ta, ja = BlockAllocator(17), JAllocator(17)
    held = set()
    rng = np.random.default_rng(seed)
    for _ in range(200):
        if held and rng.random() < 0.4:
            n = rng.integers(1, len(held) + 1)
            victims = rng.choice(sorted(held), size=n, replace=False)
            ta.free(victims)
            ja.free(victims)
            held -= set(int(v) for v in victims)
        else:
            n = int(rng.integers(1, 4))
            if n <= ta.available:
                got = ta.alloc(n)
                assert got == ja.alloc(n)
                assert not (set(got) & held) and NULL_BLOCK not in got
                held |= set(got)
        assert (ta.in_use, ta.available, ta.peak_in_use) == (
            ja.in_use, ja.available, ja.peak_in_use) and ta.in_use == len(held)


def test_allocator_fragmentation_then_drain_returns_all():
    alloc = BlockAllocator(33)
    total = alloc.available
    slabs = [alloc.alloc(4) for _ in range(8)]
    for s in slabs[::2]:
        alloc.free(s)
    odd = [alloc.alloc(3) for _ in range(5)]
    for s in slabs[1::2] + odd:
        alloc.free(s)
    assert alloc.available == total and alloc.in_use == 0
    assert alloc.peak_in_use == 8 * 4


def test_allocator_errors():
    alloc = BlockAllocator(5)
    got = alloc.alloc(4)
    with pytest.raises(MemoryError):
        alloc.alloc(1)
    alloc.free(got[:2])
    with pytest.raises(ValueError):
        alloc.free(got[:1])          # double free
    with pytest.raises(ValueError):
        alloc.free([NULL_BLOCK])     # reserved
    with pytest.raises(ValueError):
        alloc.free([99])             # foreign
    with pytest.raises(ValueError):
        BlockAllocator(1)


# ------------------------------------------------- paged cache view
def _views(arch="qwen2-0.5b", kv_quant=None, **kw):
    """The JAX and the port's view of one SMOKE model; ``kv_quant`` is set
    on the model's config, whose cache spec the view reads."""
    jv = JView(j_build_model(j_get_smoke(arch).replace(kv_quant=kv_quant)),
               **kw)
    tv = PagedCacheView(build_model(get_smoke(arch).replace(
        kv_quant=kv_quant), device="cpu"), **kw)
    return jv, tv


def test_view_tables_and_clamp_match_jax():
    jv, tv = _views(n_slots=2, max_len=64, block_size=8)
    assert tv.paged and tv.tokens_per_slot == 64 == jv.tokens_per_slot
    assert tv.max_blocks_per_slot == jv.max_blocks_per_slot
    jv.init_cache()
    tv.init_cache()
    for slot, n in ((0, 20), (1, 1), (0, 21)):     # 3 blocks, 1, no growth
        jv.ensure(slot, n)
        tv.ensure(slot, n)
        np.testing.assert_array_equal(tv.device_tables().numpy(),
                                      np.asarray(jv.device_tables()))
    t = tv.device_tables().numpy()
    assert (t[0, :3] > 0).all() and (t[0, 3:] == t[0, 2]).all()
    assert (t[1, 1:] == t[1, 0]).all()
    assert tv.allocator.in_use == 4
    np.testing.assert_array_equal(tv.wave_tables([1, 0], 4),
                                  jv.wave_tables([1, 0], 4))
    jv.release(0)
    tv.release(0)
    assert tv.allocator.in_use == 1
    assert (tv.device_tables().numpy()[0] == NULL_BLOCK).all()
    np.testing.assert_array_equal(tv.device_tables().numpy(),
                                  np.asarray(jv.device_tables()))


def test_device_tables_upload_only_after_an_edit():
    """One device buffer, refreshed in place only after a table edit (a
    captured decode graph reads that buffer at every replay)."""
    _, tv = _views(n_slots=2, max_len=64, block_size=8)
    tv.ensure(0, 9)
    first = tv.device_tables()
    ptr, uploads = first.data_ptr(), tv.uploads
    assert tv.device_tables() is first
    tv.ensure(0, 10)                 # same block count: no edit
    assert tv.device_tables() is first and tv.uploads == uploads
    tv.ensure(0, 17)
    again = tv.device_tables()
    assert again is first and again.data_ptr() == ptr
    assert tv.uploads == uploads + 1
    np.testing.assert_array_equal(again.numpy(), tv.host_tables())


def test_ensure_out_of_blocks_is_atomic():
    """A failed grow raises MemoryError and leaves tables, counts and the
    free list as they were."""
    _, tv = _views(n_slots=2, max_len=64, block_size=8, n_blocks=8)
    tv.ensure(0, 40)                          # 5 blocks -> 2 left
    assert tv.allocator.available == 2
    tables, counts = tv._tables.copy(), tv._counts.copy()
    with pytest.raises(MemoryError):
        tv.ensure(1, 4 * 8)                   # wants 4, has 2
    np.testing.assert_array_equal(tv._tables, tables)
    np.testing.assert_array_equal(tv._counts, counts)
    assert tv.allocator.available == 2
    tv.ensure(1, 2 * 8)
    assert int(tv._counts[1]) == 2


@pytest.mark.parametrize("kv_quant", [None, "nf4", "int8"])
def test_view_layout_and_stats_match_jax(kv_quant):
    jv, tv = _views("llama2-7b-proxy", n_slots=3, max_len=48, block_size=8,
                    n_blocks=14, kv_quant=kv_quant)
    jc, tc = jv.init_cache(), tv.init_cache()
    assert list(tv.serve_spec) == list(jv.serve_spec)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        assert str(tc[key].dtype)[6:] == str(jc[key].dtype)
    for slot, n in ((0, 17), (2, 40), (1, 3)):
        jv.ensure(slot, n)
        tv.ensure(slot, n)
    jv.release(2)
    tv.release(2)
    assert tv.stats() == jv.stats()
    assert tv.kv_quant == kv_quant


@pytest.mark.parametrize("skip_paged", [False, True])
def test_reset_and_merge_cache_slots_match_jax(skip_paged):
    """Slot surgery on a cache whose KV leaves are paged-poolable: reset
    fills the slots (pools left alone under ``skip_paged``), and the merge
    keeps new stripes of active slots (pools taken whole)."""
    from repro.models.common import (
        merge_cache_slots as j_merge, reset_cache_slots as j_reset,
    )
    from repro_torch.models.common import (
        merge_cache_slots, reset_cache_slots,
    )

    arch = "llama2-7b-proxy"
    jm, tm = j_build_model(j_get_smoke(arch)), build_model(get_smoke(arch),
                                                           device="cpu")
    rs = np.random.RandomState(0)
    old = {k: rs.standard_normal(t.shape).astype(np.float32)
           for k, t in tm.init_cache(3, 8, device="meta").items()}
    old["len"] = np.array([4, 5, 6], np.int32)
    new = {k: (v + 1).astype(v.dtype) for k, v in old.items()}
    active = np.array([True, False, True])
    want = j_merge(jm.cache_spec(), {k: jnp.asarray(v) for k, v in new.items()},
                   {k: jnp.asarray(v) for k, v in old.items()}, active,
                   skip_paged=skip_paged)
    got = merge_cache_slots(tm.cache_spec(),
                            {k: torch.from_numpy(v) for k, v in new.items()},
                            {k: torch.from_numpy(v) for k, v in old.items()},
                            active, skip_paged=skip_paged)
    want = j_reset(jm.cache_spec(), want, [1], skip_paged=skip_paged)
    got = reset_cache_slots(tm.cache_spec(), got, [1], skip_paged=skip_paged)
    for key in old:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_view_refuses_data_shards():
    """``data_shards=2`` (once refused here) cuts the pool into the JAX
    view's arenas: the same blocks from each slot's own arena, per-arena
    null rows in the tables and the wave padding, the same stats; an
    uneven slot split still raises."""
    jv, tv = _views(n_slots=4, max_len=64, block_size=8, data_shards=2)
    assert (tv.n_blocks, tv.arena_size, tv.max_request_blocks) == (
        jv.n_blocks, jv.arena_size, jv.max_request_blocks)
    for slot, n in ((0, 20), (3, 9), (2, 30)):
        tv.ensure(slot, n)
        jv.ensure(slot, n)
    tv.release(2)
    jv.release(2)
    tv.ensure(1, 17)
    jv.ensure(1, 17)
    np.testing.assert_array_equal(tv.host_tables(),
                                  np.asarray(jv.device_tables()))
    np.testing.assert_array_equal(tv.wave_tables(np.array([3, 1]), 4),
                                  jv.wave_tables(np.array([3, 1]), 4))
    assert [tv.shard_of(s) for s in range(4)] == [
        jv.shard_of(s) for s in range(4)]
    assert tv.null_of(1) == jv.null_of(1) == tv.arena_size
    for key in ("blocks_in_use", "blocks_total", "peak_blocks_in_use"):
        assert tv.stats()[key] == jv.stats()[key]
    with pytest.raises(ValueError, match="divide evenly"):
        PagedCacheView(build_model(get_smoke("qwen2-0.5b"), device="cpu"),
                       n_slots=3, max_len=32, block_size=8, data_shards=2)


# ----------------------------------- paged decode: plain vs JAX interpret
def _paged_inputs(quant, seed=0):
    rs = np.random.RandomState(seed)
    b, h, kv, hd, bs, n_b = 3, 4, 2, 32, 8, 6
    lens = np.array([1, 20, 45], np.int32)
    n_blocks = b * n_b + 1
    perm = rs.permutation(np.arange(1, n_blocks))
    tables = np.zeros((b, n_b), np.int32)
    used = 0
    for i, n in enumerate(lens):         # shuffled rows, repeated tails
        c = -(-n // bs)
        tables[i, :c] = perm[used:used + c]
        tables[i, c:] = tables[i, c - 1]
        used += c
    q = rs.standard_normal((b, 1, h, hd)).astype(np.float32)
    k = rs.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32)
    v = rs.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32)
    extra = {}
    if quant is not None:
        (k, ks), (v, vs) = (j_quantize_kv(jnp.asarray(k), quant),
                            j_quantize_kv(jnp.asarray(v), quant))
        k, v = np.array(k), np.array(v)
        extra = dict(kv_quant=quant, k_scales=np.array(ks),
                     v_scales=np.array(vs))
    return q, k, v, tables, lens, extra


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("quant", [None, "nf4", "int8"])
def test_paged_decode_plain_matches_jax_kernel(quant, window):
    q, k, v, tables, lens, extra = _paged_inputs(quant)
    want = np.asarray(j_fa.paged_flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), window=window, interpret=True,
        **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in extra.items()}))
    before = launch_counts()
    got = FA.paged_flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lens), window=window,
        **{n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in extra.items()})
    assert launch_counts() == before          # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def test_paged_plain_ignores_table_tails_and_other_slots_blocks():
    """Rows past a slot's length, and pool rows no table names, are never
    read: poisoning them changes nothing."""
    q, k, v, tables, lens, _ = _paged_inputs(None, seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    want = FA.paged_decode_attention_plain(*args)
    k2, v2 = k.copy(), v.copy()
    named = set(tables.ravel().tolist())
    for blk in range(k.shape[0]):
        if blk not in named:
            k2[blk] = v2[blk] = 1e4
    bs = k.shape[1]
    for i, n in enumerate(lens):
        blk, row = tables[i, (n - 1) // bs], (n - 1) % bs
        k2[blk, row + 1:] = v2[blk, row + 1:] = 1e4
    got = FA.paged_decode_attention_plain(
        args[0], torch.from_numpy(k2), torch.from_numpy(v2), *args[3:])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------- paged decode at more shapes, f32 vs JAX
def _pool_case(bs, n_b, lens, h, kv, hd, seed):
    """A pool of ``bs``-token blocks holding ``lens`` tokens per slot,
    through shuffled tables whose tails repeat each slot's last row."""
    rs = np.random.RandomState(seed)
    b = len(lens)
    n_blocks = b * n_b + 1
    perm = rs.permutation(np.arange(1, n_blocks))
    tables = np.zeros((b, n_b), np.int32)
    used = 0
    for i, n in enumerate(lens):
        c = max(1, -(-n // bs))
        tables[i, :c] = perm[used:used + c]
        tables[i, c:] = tables[i, c - 1]
        used += c
    q = rs.standard_normal((b, 1, h, hd)).astype(np.float32)
    k = rs.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32)
    v = rs.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32)
    return q, k, v, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("bs,n_b,lens,h,kv,window", [
    (8, 40, [1, 64, 65, 320], 2, 2, None),     # G 1, 5 tiles
    (5, 30, [150, 66, 1], 7, 1, 70),           # bs not dividing 64, G 7
    (16, 12, [192, 129, 64], 16, 2, 1),        # G 8, window 1
    (16, 70, [1120, 300, 1], 2, 2, 200),       # 18 tiles, the last ragged
])
def test_paged_decode_at_split_plan_shapes_matches_jax_kernel(bs, n_b, lens,
                                                              h, kv,
                                                              window):
    """The paged decode's plain version in float32 against the JAX kernel
    in interpret mode, over extents of 150 to 1120 positions (those at
    which the bf16 kernel's score pass takes several chunks; the plain
    version has no split, so this is shape coverage)."""
    hd = 16
    q, k, v, tables, ln = _pool_case(bs, n_b, lens, h, kv, hd, bs + n_b)
    want = np.asarray(j_fa.paged_flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ln), window=window, interpret=True))
    got = FA.paged_flash_decode_attention(
        *(torch.from_numpy(x) for x in (q, k, v, tables, ln)), window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def test_paged_plain_ignores_the_block_size():
    """One logical cache stored in pools of 4-, 16- and 64-token blocks
    gives the bf16 plain paged decode the same bits, and those of the
    dense decode on that cache."""
    lens, hd = [256, 65, 1, 200], 16
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in ((4, 1, 4, hd),
                                              (4, 256, 2, hd),
                                              (4, 256, 2, hd)))
    ln = torch.tensor(lens, dtype=torch.int32)
    dense = FA.flash_decode_attention_plain(q, k, v, ln)
    for bs in (4, 16, 64):
        _, pool, _, tables, _ = _pool_case(bs, 256 // bs, lens, 4, 2, hd, bs)
        # the slots' blocks of the dense cache, into this pool's rows
        kp = torch.zeros(pool.shape, dtype=torch.bfloat16)
        vp = torch.zeros_like(kp)
        t = torch.from_numpy(tables).long()
        for i, n in enumerate(lens):
            for j in range(max(1, -(-n // bs))):
                kp[t[i, j]] = k[i, j * bs:(j + 1) * bs]
                vp[t[i, j]] = v[i, j * bs:(j + 1) * bs]
        got = FA.paged_decode_attention_plain(q, kp, vp, t.int(), ln)
        assert torch.equal(got, dense), bs


# ------------------------------------------------------------ engine parity
PROMPTS = [[3, 141, 59] * 3, [26, 5], [35, 89, 79, 32] * 4, [38, 46],
           [2, 7, 18]]
# case -> (cfg.kv_quant, engine options); "tight" pools preempt
CASES = {
    "rows": (None, dict(cache="paged", block_size=8)),
    "nf4 KV": ("nf4", dict(cache="paged", block_size=8, kv_quant="nf4")),
    "int8 KV": ("int8", dict(cache="paged", block_size=8, kv_quant="int8")),
    "nf4 KV, nf4 base, tight": ("nf4", dict(cache="paged", block_size=4,
                                            n_blocks=12, kv_quant="nf4",
                                            base_quant="nf4")),
    "rows, int8 base, tight": (None, dict(cache="paged", block_size=4,
                                          n_blocks=12, base_quant="int8")),
}


@functools.lru_cache(maxsize=None)
def _jax_weights(arch):
    model = j_build_model(j_get_smoke(arch))
    params = model.init(jax.random.PRNGKey(0))
    base, peft = j_attach(jax.random.PRNGKey(1), params,
                          JPeftConfig(method="quanta",
                                      n_axes=get_peft(arch).n_axes))
    rs = np.random.RandomState(3)
    peft = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), peft)
    return base, peft


@functools.lru_cache(maxsize=None)
def _jax_run(arch, case, which):
    base, peft = _jax_weights(arch)
    kv_quant, opts = CASES[case]
    model = j_build_model(j_get_smoke(arch).replace(kv_quant=kv_quant))
    params, adapters = ((base, peft) if which == "adapted"
                        else (j_merge_all(base, peft), None))
    eng = JEngine(model, params, adapters, n_slots=4, max_len=64,
                  admission="prefill", **opts)
    reqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.output for r in reqs], eng.stats["preemptions"]


def _serve(arch, case, which, backend, cache=None):
    base, peft = _jax_weights(arch)
    kv_quant, opts = CASES[case]
    if cache is not None:
        opts = dict(opts, cache=cache)
    model = build_model(get_smoke(arch).replace(
        attn_backend=backend, peft_backend=backend, kv_quant=kv_quant),
        device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    tpeft = interop.adapter_set_from_numpy(peft, "cpu")
    if which == "merged":
        tbase, tpeft = merge_all(tbase, tpeft), None
    eng = ServingEngine(model, tbase, tpeft, n_slots=4, max_len=64,
                        device="cpu", **opts)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.output) == 8 for r in reqs)
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("which", ["adapted", "merged"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ["llama2-7b-proxy", "qwen2-0.5b"])
def test_paged_engine_tokens_match_jax(arch, case, which, backend):
    want, j_preempt = _jax_run(arch, case, which)
    got, eng = _serve(arch, case, which, backend)
    assert got == want
    assert eng.stats["preemptions"] == j_preempt
    if "tight" in case:
        assert j_preempt >= 1
    assert eng.stats["blocks_in_use"] == 0      # every block came back
    if "KV" in case and "tight" not in case:
        # the dense engine with fake-quantized rows is the token-for-token
        # reference of the quantized pools (without preemption; see
        # test_tight_pool_follows_dense_twin_up_to_preemption)
        dense, _ = _serve(arch, case, which, backend, cache="dense")
        assert dense == got


@pytest.mark.parametrize("arch,case", [("yi-6b", "nf4 KV")] + [
    (a, "nf4 KV, nf4 base, tight")
    for a in ("yi-6b", "phi3-medium-14b", "minicpm-2b")])
def test_dense_family_paged_nf4_tokens_match_jax(arch, case):
    """The rest of the dense family's SMOKE configs, adapted, through the
    kernel backend's wrappers: paged NF4 KV codes under an NF4 base in a
    pool that preempts, and for yi-6b also paged NF4 KV alone beside the
    dense twin of fake-quantized rows."""
    want, j_preempt = _jax_run(arch, case, "adapted")
    got, eng = _serve(arch, case, "adapted", "pallas")
    assert got == want
    assert eng.stats["preemptions"] == j_preempt
    assert (j_preempt >= 1) == ("tight" in case)
    if "tight" not in case:
        dense, _ = _serve(arch, case, "adapted", "pallas", cache="dense")
        assert dense == got


@functools.lru_cache(maxsize=None)
def _tight_vs_dense(impl, kv_quant, cache):
    """Tokens and preemptions ``(request, tokens it had)`` of the JAX or
    the port's engine on llama2-7b-proxy SMOKE, adapted, over a paged pool
    too small for the batch or over the dense cache."""
    arch = "llama2-7b-proxy"
    opts = (dict(cache="paged", block_size=4, n_blocks=12)
            if cache == "paged" else dict(cache="dense"))
    base, peft = _jax_weights(arch)
    if impl == "jax":
        eng = JEngine(j_build_model(j_get_smoke(arch).replace(
            kv_quant=kv_quant)), base, peft, n_slots=4, max_len=64,
            admission="prefill", kv_quant=kv_quant, **opts)
        make = JRequest
    else:
        eng = ServingEngine(
            build_model(get_smoke(arch).replace(kv_quant=kv_quant),
                        device="cpu"),
            interop.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, base), "cpu"),
            interop.adapter_set_from_numpy(peft, "cpu"), n_slots=4,
            max_len=64, kv_quant=kv_quant, device="cpu", **opts)
        make = Request
    preempted, preempt = [], eng._preempt

    def record(slot):
        preempted.append((eng.slots[slot].uid, len(eng.slots[slot].output)))
        preempt(slot)

    eng._preempt = record
    reqs = [make(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.output for r in reqs], preempted


@pytest.mark.parametrize("kv_quant", [None, "nf4"])
@pytest.mark.parametrize("impl", ["jax", "port"])
def test_tight_pool_follows_dense_twin_up_to_preemption(impl, kv_quant):
    """Recompute preemption against the dense twin, in the JAX engine and
    in the port's.  Over rows the re-prefilled stream continues exactly;
    over NF4 codes the re-prefill attends to unquantized rows where the
    dense twin decoded over fake-quantized ones, so a preempted request
    matches the twin up to its preemption and then leaves it.  The port
    preempts the same requests at the same points and gives JAX's
    tokens."""
    tight, preempted = _tight_vs_dense(impl, kv_quant, "paged")
    dense, none = _tight_vs_dense(impl, kv_quant, "dense")
    assert preempted == [(3, 3), (2, 5)] and none == []
    first = {}
    for uid, n in preempted:
        first.setdefault(uid, n)
    for uid, (t, d) in enumerate(zip(tight, dense)):
        cut = first.get(uid, len(t)) if kv_quant else len(t)
        assert t[:cut] == d[:cut], uid
    if kv_quant:
        assert [i for i, (t, d) in enumerate(zip(tight, dense))
                if t != d] == [3]
    if impl == "port":
        assert (tight, preempted) == _tight_vs_dense("jax", kv_quant,
                                                     "paged")


def test_paged_engine_refuses_a_request_that_could_never_fit():
    model = build_model(get_smoke("qwen2-0.5b"), device="cpu")
    eng = ServingEngine(model, model.init(0), n_slots=2, max_len=64,
                        cache="paged", block_size=8, n_blocks=6,
                        device="cpu")
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit(Request(uid=9, prompt=[1] * 30, max_new_tokens=30))
