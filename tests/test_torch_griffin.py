"""The port's Griffin (recurrentgemma-2b SMOKE: one macro block and a
1-layer tail) held against the JAX package on the same inputs: the linear
scan it shares with Mamba2 against ``jax.lax.associative_scan`` at f32
1e-6, the recurrent block
with and without prefill lengths and one decode step, the local-attention
prefill with its ring and each decode branch (dense ring, paged ring of
rows, paged ring of NF4 codes), forward and loss with the QuanTA
gradients at 1e-4, prefill then 40 greedy decode steps through a ring of
16 rows (it wraps), the flash forward's plain version at head_dim 256
against the Pallas kernel in interpret mode, ``gather_conv_tail``, and
the carry-over of weights and adapters with the unstacked ``tail``
subtree (attach, bank, merge).  Weights and perturbed QuanTA come from
the JAX package through ``interop``."""

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
from repro.models import common as jcommon
from repro.models import griffin as jgriffin
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.adapters import tree_leaves, tree_map
from repro_torch.core.bank import AdapterBank
from repro_torch.core.peft import (
    adapter_subtree, flatten_paths, layer_tree, merge_all,
)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import Griffin, build_model
from repro_torch.models import common as tcommon

jfa = importlib.import_module("repro.kernels.flash_attention")

ARCH = "recurrentgemma-2b"
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    jm = j_build_model(j_get_smoke(ARCH))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    peft_cfg = get_peft(ARCH)
    base, peft = jax.jit(lambda p: j_attach(
        jax.random.PRNGKey(1), p, JPeftConfig(
            method="quanta", n_axes=peft_cfg.n_axes,
            targets=peft_cfg.targets)))(params)
    rs = np.random.RandomState(3)
    peft = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), peft)
    return params, base, peft


def _pair(**cfg_kw):
    """(jax model, jax base, jax peft, port model, port base, port peft),
    the port on the kernel backends' wrappers (their plain versions on the
    CPU)."""
    _, base, peft = _jax_weights()
    jm = j_build_model(j_get_smoke(ARCH).replace(**cfg_kw))
    tm = build_model(get_smoke(ARCH).replace(
        attn_backend="pallas", peft_backend="pallas", **cfg_kw), device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    return jm, base, peft, tm, tbase, interop.adapter_set_from_numpy(
        peft, "cpu")


def _tokens(b, s, seed=4):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **(tol or TOL))


# Griffin's RG-LRU: a and b (2, s, 8); Mamba2's chunk states: a (B, nc, H,
# 1, 1) broadcast over b (B, nc, H, N, P), nc chunks
SCAN_CASES = [(2, s, 8) for s in (1, 2, 3, 7, 64, 384)] + [
    (2, nc, 3, 4, 5) for nc in (1, 5, 64)]


@pytest.mark.parametrize("shape", SCAN_CASES, ids=lambda sh: (
    f"mamba2-nc{sh[1]}" if len(sh) == 5 else str(sh[1])))
def test_lru_scan_matches_associative_scan(shape):
    """The shared linear scan (``common.linear_scan``) at each position at
    f32 1e-6 against ``jax.lax.associative_scan``: Griffin's ``_lru_scan``
    at odd lengths included, and Mamba2's combine ``(al * ar, sr + ar *
    sl)`` with ``a`` broadcast over the ``(N, P)`` state; the scan also
    carries gradients."""
    rs = np.random.RandomState(shape[1])
    mamba = len(shape) == 5
    a_shape = shape[:3] + (1, 1) if mamba else shape
    a = rs.uniform(0.5, 1.0, a_shape).astype(np.float32)
    b = rs.standard_normal(shape).astype(np.float32)
    if mamba:
        def combine(left, right):
            al, sl = left
            ar, sr = right
            return al * ar, sr + ar * sl

        want = np.asarray(jax.jit(lambda a, b: jax.lax.associative_scan(
            combine, (a, b), axis=1)[1])(jnp.asarray(a), jnp.asarray(b)))
    else:
        want = np.asarray(jax.jit(jgriffin._lru_scan)(jnp.asarray(a),
                                                      jnp.asarray(b)))
    ta, tb = (torch.from_numpy(t).requires_grad_(True) for t in (a, b))
    got = tcommon.linear_scan(ta, tb)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    # the recurrence itself, as a plain loop
    h, ref = np.zeros((shape[0],) + shape[2:], np.float32), []
    for t in range(shape[1]):
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    np.testing.assert_allclose(want, np.stack(ref, 1), rtol=1e-5, atol=1e-5)
    got.sum().backward()
    assert torch.isfinite(tb.grad).all() and tb.grad[:, -1].eq(1).all()
    assert shape[1] == 1 or torch.isfinite(ta.grad).all()


def _block(tree, key, i=0):
    """Macro block ``i``'s ``key`` subtree of a JAX tree."""
    return jax.tree_util.tree_map(lambda t: t[i], tree["blocks"][key])


@pytest.mark.parametrize("lengths", [None, (12, 5, 9)])
def test_rec_block_matches_jax(lengths):
    """The recurrent block over a sequence (without lengths, and with a
    right-padded wave whose decode-ready LRU and conv states it returns),
    then one decode step from those states, at 1e-4."""
    jm, base, peft, tm, tbase, tpeft = _pair()
    lp, la = _block(base, "rec1"), _block(peft.tree, "rec1")
    tlp = layer_tree(tbase["blocks"], 0)["rec1"]
    tla = layer_tree(adapter_subtree(tpeft, "blocks"), 0)["rec1"]
    x = _x((3, 12, 64))
    lens = None if lengths is None else np.array(lengths, np.int32)
    jx, jst = jax.jit(functools.partial(jm._rec_block, lp, la))(
        jnp.asarray(x), prefill_lengths=None if lens is None
        else jnp.asarray(lens))
    tx, tst = tm._rec_block(tlp, tla, torch.from_numpy(x),
                            prefill_lengths=None if lens is None
                            else torch.from_numpy(lens))
    _close(tx, jx)
    if lens is None:
        assert jst is None and tst is None
        return
    for g, w in zip(tst, jst):
        _close(g, w)
    step = _x((3, 1, 64), seed=1)
    jy, (jh, jc) = jax.jit(functools.partial(jm._rec_block, lp, la))(
        jnp.asarray(step), state=jst)
    ty, (th, tc) = tm._rec_block(tlp, tla, torch.from_numpy(step),
                                 state=tst)
    for g, w in ((ty, jy), (th, jh), (tc, jc)):
        _close(g, w)


def _ring_inputs(s=20, lens=(20, 7, 13)):
    jm, base, peft, tm, tbase, tpeft = _pair()
    lp, la = _block(base, "attn"), _block(peft.tree, "attn")
    tlp = layer_tree(tbase["blocks"], 0)["attn"]
    tla = layer_tree(adapter_subtree(tpeft, "blocks"), 0)["attn"]
    cfg = tm.cfg
    x = _x((len(lens), s, 64))
    lens = np.array(lens, np.int32)
    jrope = jcommon.make_rope(jnp.arange(s)[None, :], cfg.head_dim,
                              cfg.rope_theta)
    trope = tcommon.make_rope(torch.arange(s)[None, :], cfg.head_dim,
                              cfg.rope_theta)
    return jm, tm, (lp, la, tlp, tla), x, lens, jrope, trope


def test_attn_block_prefill_and_ring_match_jax():
    """The windowed prefill attention (kernel 3's plain version; the
    window of 32 binds at 40 positions) and the decode ring it builds:
    keys and values at 1e-4, positions exactly, on rows shorter and
    longer than the window."""
    jm, tm, (lp, la, tlp, tla), x, lens, jrope, trope = _ring_inputs(
        s=40, lens=(40, 7, 33))
    jx, jring = jax.jit(functools.partial(jm._attn_block, lp, la))(
        jnp.asarray(x), jrope, prefill_lengths=jnp.asarray(lens))
    tx, tring = tm._attn_block(tlp, tla, torch.from_numpy(x), trope,
                               prefill_lengths=torch.from_numpy(lens))
    _close(tx, jx)
    _close(tring[0], jring[0])
    _close(tring[1], jring[1])
    np.testing.assert_array_equal(tring[2].numpy(), np.asarray(jring[2]))
    assert tring[2].dtype == torch.int32
    assert (tring[2][1] >= 0).sum() == 7 and (tring[2][0] >= 0).all()


@pytest.mark.parametrize("branch", ["dense", "paged", "paged nf4"])
def test_attn_decode_branches_match_jax(branch):
    """One decode step of local attention from a prefill ring, through
    the dense ring (4-tuple), a paged ring of rows (5-tuple) and a paged
    ring of NF4 codes (7-tuple) in blocks of 8 rows through shuffled
    tables: the output and every written leaf against the JAX branch."""
    kv_quant = "nf4" if branch == "paged nf4" else None
    jm, tm, (lp, la, tlp, tla), x, lens, jrope, trope = _ring_inputs()
    if kv_quant:
        jm = j_build_model(j_get_smoke(ARCH).replace(kv_quant=kv_quant))
        tm = build_model(get_smoke(ARCH).replace(
            attn_backend="pallas", peft_backend="pallas", kv_quant=kv_quant),
            device="cpu")
    cfg = tm.cfg
    _, (k_r, v_r, pos_r) = jax.jit(functools.partial(jm._attn_block, lp, la))(
        jnp.asarray(x), jrope, prefill_lengths=jnp.asarray(lens))
    b, w = len(lens), cfg.local_window
    new_len = lens + 1
    step = _x((b, 1, 64), seed=2)
    jr = jcommon.make_rope(jnp.asarray(lens)[:, None], cfg.head_dim,
                           cfg.rope_theta)
    tr = tcommon.make_rope(torch.from_numpy(lens)[:, None], cfg.head_dim,
                           cfg.rope_theta)
    k_np, v_np, pos_np = (np.asarray(t) for t in (k_r, v_r, pos_r))
    if branch == "dense":
        jcache = (k_r, v_r, pos_r, jnp.asarray(new_len))
        ring = tuple(torch.from_numpy(t.copy()) for t in (k_np, v_np, pos_np))
        tables = None
    else:
        bs, nb = 8, w // 8
        perm = np.random.RandomState(7).permutation(b * nb) + 1
        tables = perm.reshape(b, nb).astype(np.int32)

        def pool(t):
            out = np.zeros((b * nb + 1, bs) + t.shape[2:], t.dtype)
            out[tables.reshape(-1)] = t.reshape((b * nb, bs) + t.shape[2:])
            return out

        pools = [pool(k_np), pool(v_np), pool(pos_np)]
        if kv_quant:
            (kc, ks), (vc, vs) = (
                j_quantize_kv(jnp.asarray(p), kv_quant,
                              block_size=cfg.quant_block_size)
                for p in pools[:2])
            pools = [np.asarray(t) for t in (kc, ks, vc, vs)] + [pools[2]]
        ring = tuple(torch.from_numpy(p.copy()) for p in pools)
        jcache = tuple(jnp.asarray(p) for p in pools[:-1]) + (
            jnp.asarray(pools[-1]), jnp.asarray(new_len),
            jnp.asarray(tables))
    jy, jnew = jax.jit(functools.partial(jm._attn_block, lp, la))(
        jnp.asarray(step), jr, cache=jcache)
    ty = tm._attn_step(tlp, tla, torch.from_numpy(step), tr, ring,
                       torch.from_numpy(new_len),
                       None if tables is None else torch.from_numpy(tables))
    _close(ty, jy)
    for got, want in zip(ring, jnew):
        if got.is_floating_point():
            _close(got, want)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_and_loss_match_jax():
    """Forward logits at 1e-4, the loss (through the per-macro
    checkpoint) and its gradient on every QuanTA tensor, the tail's
    among them, at 1e-4."""
    jm, base, peft, tm, tbase, tpeft = _pair()
    toks = _tokens(2, 24)
    lj, _ = jax.jit(jm.forward)(base, {"tokens": jnp.asarray(toks)}, peft)
    lt, aux = tm.forward(tbase, {"tokens": torch.from_numpy(toks)}, tpeft)
    _close(lt, lj)
    assert aux == 0.0
    rng = np.random.RandomState(6)
    batch = {"tokens": rng.randint(0, 256, (2, 24)).astype(np.int32),
             "labels": rng.randint(0, 256, (2, 24)).astype(np.int32)}
    batch["labels"][0, :3] = -100
    tm = build_model(get_smoke(ARCH).replace(attn_backend="pallas"),
                     device="cpu")
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(base, p, {
        k: jnp.asarray(v) for k, v in batch.items()})))(peft)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(tpeft)]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), tpeft)
    tl = tm.loss(tbase, tree, batch)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, leaves)
    want = tree_leaves(interop.adapter_set_from_numpy(jg, "cpu"))
    assert len(want) == len(grads) > 0
    for got, w in zip(grads, want):
        assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert not any(t.requires_grad or t.grad is not None
                   for t in tree_leaves(tbase))


def test_prefill_then_decode_wraps_the_ring():
    """Prefill (lengths 9 and 14) then 40 greedy decode steps through a
    16-row ring, which wraps twice: every step's logits at 1e-4 and the
    same greedy tokens as the JAX model; the ring's positions equal."""
    jm, base, peft, tm, tbase, tpeft = _pair(local_window=16)
    toks = _tokens(2, 14)
    lens = np.array([9, 14], np.int32)
    lj, cj = jax.jit(jm.prefill)(base, peft, {"tokens": jnp.asarray(toks)},
                                 lengths=jnp.asarray(lens))
    lt, ct = tm.prefill(tbase, tpeft, {"tokens": torch.from_numpy(toks)},
                        lengths=torch.from_numpy(lens))
    _close(lt, lj)
    jc = jm.insert_cache(jm.init_cache(3, 64), np.array([2, 0]), cj)
    tc = tm.insert_cache(tm.init_cache(3, 64), np.array([2, 0]), ct)
    decode = jax.jit(lambda c, t: jm.decode_step(base, peft, c,
                                                 {"tokens": t}))
    nxt = np.zeros((3, 1), np.int32)
    nxt[[2, 0], 0] = np.asarray(jnp.argmax(lj[:, 0, :256], -1))
    got_toks, want_toks = [], []
    for _ in range(40):
        lj, jc = decode(jc, jnp.asarray(nxt))
        lt, tc = tm.decode_step(tbase, tpeft, tc,
                                {"tokens": torch.from_numpy(nxt)})
        _close(lt[..., :256], lj[..., :256])
        want = np.array(jnp.argmax(lj[..., :256], -1), np.int32)
        got = lt[..., :256].argmax(-1).numpy().astype(np.int32)
        want_toks.append(want[[2, 0], 0].tolist())
        got_toks.append(got[[2, 0], 0].tolist())
        nxt = want
    assert got_toks == want_toks
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["len"].tolist()[::2] == [54, 49]


@pytest.mark.parametrize("window", [None, 40])
def test_flash_plain_at_head_dim_256_matches_pallas(window):
    """Kernel 3's plain version (what the CUDA kernel is held against on
    the card) at Griffin's head_dim of 256, 4 query heads over 1 KV head,
    against the JAX flash kernel in Pallas interpret mode at f32 3e-5."""
    rs = np.random.RandomState(0)
    q, k, v = (rs.standard_normal(shape).astype(np.float32) for shape in
               ((1, 100, 4, 256), (1, 100, 1, 256), (1, 100, 1, 256)))
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=32, block_k=32))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def test_gather_conv_tail_matches_jax():
    """The conv state a right-padded wave hands to decode: rows shorter
    than the tail are zero-filled at the front, exactly as JAX."""
    x = _x((4, 10, 6))
    lens = np.array([10, 1, 3, 7], np.int32)
    for window in (1, 3, 5):
        want = np.asarray(jcommon.gather_conv_tail(
            jnp.asarray(x), jnp.asarray(lens), window))
        got = tcommon.gather_conv_tail(torch.from_numpy(x),
                                       torch.from_numpy(lens), window)
        np.testing.assert_array_equal(got.numpy(), want)
    assert not got[1, :4].any() and torch.equal(got[1, 4], torch.from_numpy(
        x[1, 0]))


def test_weights_and_adapters_carry_over_with_the_tail():
    """Every weight, stacked ``blocks`` and unstacked ``tail`` alike,
    carries over by a plain copy; the QuanTA adapters attach at the
    config's six kinds of path (``tail/rec1/rec_proj`` unstacked), a bank
    over them holds stacked and unstacked paths side by side, and the
    merged weights equal the JAX package's."""
    params, base, peft = _jax_weights()
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    jflat = flatten_paths(jax.tree_util.tree_map(np.asarray, base))
    tflat = flatten_paths(tbase)
    assert sorted(jflat) == sorted(tflat)
    assert any(p.startswith("tail/") for p in tflat)
    for path, w in jflat.items():
        np.testing.assert_array_equal(tflat[path].numpy(), w)
    tpeft = interop.adapter_set_from_numpy(peft, "cpu")
    assert sorted(tpeft.paths) == [
        "blocks/attn/q_proj", "blocks/attn/v_proj", "blocks/rec1/rec_proj",
        "blocks/rec2/rec_proj", "tail/rec1/rec_proj"]
    stacked = {s.path: s.stacked for s in tpeft.specs}
    assert stacked["tail/rec1/rec_proj"] is False
    assert stacked["blocks/rec1/rec_proj"] is True
    tparams = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    bank = AdapterBank.build(tparams, {"t": (tbase, tpeft)})
    assert sorted(flatten_paths(bank.tree)) == sorted(tpeft.paths)
    assert flatten_paths(bank.tree)["tail/rec1/rec_proj"].stacked is False
    merged = merge_all(tbase, tpeft)
    jmerged = flatten_paths(jax.tree_util.tree_map(
        np.asarray, j_merge_all(base, peft)))
    for path in tpeft.paths:
        _close(flatten_paths(merged)[path], jmerged[path], rtol=1e-5,
               atol=1e-5)


def test_build_model_gives_griffin_with_a_ring_cache():
    """``build_model`` gives Griffin for the hybrid family; its cache spec
    marks the ring leaves (``pos`` unquantized under ``kv_quant``), and its
    dense cache has the window's rows whatever ``max_len``."""
    cfg = get_smoke(ARCH).replace(kv_quant="nf4")
    tm = build_model(cfg, device="cpu")
    assert isinstance(tm, Griffin) and not hasattr(tm, "prefill_chunk")
    spec = tm.cache_spec()
    assert spec["k"].ring and spec["pos"].ring and spec["pos"].fill == -1
    assert spec["k"].kv_quant == "nf4" and spec["pos"].kv_quant is None
    cache = tm.init_cache(2, 500, device="meta")
    assert tuple(cache["k"].shape) == (1, 2, 32, 1, 16)
    assert cache["pos"].dtype == torch.int32
    assert set(cache) == {"lru1", "conv1", "lru2", "conv2", "k", "v", "pos",
                          "len", "tail_lru1", "tail_conv1"}


def test_merged_matches_adapted():
    """The merged weights give the adapted model's logits (f32, 1e-4 of
    the largest): the chain on q/v and every rec_proj, the tail's among
    them, folds into the weights it adapts."""
    _, _, _, tm, tbase, tpeft = _pair()
    merged = merge_all(tbase, tpeft)
    toks = torch.from_numpy(_tokens(2, 30))
    la, _ = tm.forward(tbase, {"tokens": toks}, tpeft)
    lm, _ = tm.forward(merged, {"tokens": toks}, None)
    assert float((la - lm).abs().max()) <= 1e-4 * float(lm.abs().max())
    base_only, _ = tm.forward(tbase, {"tokens": toks}, None)
    assert float((la - base_only).abs().max()) > 1e-2 * float(
        lm.abs().max())
