"""The port's Mamba2 (mamba2-1.3b SMOKE: 2 layers, d_model 64, 8 SSM heads
of 16 over a state of 16) held against the JAX package on the same inputs
in float32: ``_segsum``, the chunked SSD with and without its final state
at lengths that divide the chunk and lengths that take the
largest-divisor rule (1e-5), the block over a sequence with and without
prefill lengths and one recurrent step (1e-5), the chunked dual form
against the recurrence over a prompt of several chunks (greedy tokens
equal), forward and loss with the QuanTA gradients (1e-4), the carry-over
of weights and adapters, merged against adapted, and the cache layout.
Weights and perturbed QuanTA come from the JAX package through
``interop``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import (
    PeftConfig as JPeftConfig, attach as j_attach, merge_all as j_merge_all,
)
from repro.models import build_model as j_build_model
from repro.models import mamba2 as jmamba2
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.adapters import tree_leaves, tree_map
from repro_torch.core.bank import AdapterBank
from repro_torch.core.peft import (
    adapter_subtree, flatten_paths, layer_tree, merge_all,
)
from repro_torch.models import Mamba2, build_model
from repro_torch.models import mamba2 as tmamba2

ARCH = "mamba2-1.3b"
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _layer0(tree):
    return jax.tree_util.tree_map(lambda t: t[0], tree["layers"])


@pytest.mark.parametrize("t", [1, 5, 32])
def test_segsum_matches_jax(t):
    """The stable segment sum: below the diagonal at 1e-5, -inf above."""
    x = _x((2, 3, t))
    want = np.asarray(jax.jit(jmamba2._segsum)(jnp.asarray(x)))
    got = tmamba2._segsum(torch.from_numpy(x)).numpy()
    upper = np.triu(np.ones((t, t), bool), 1)
    assert np.isneginf(got[..., upper]).all()
    np.testing.assert_allclose(got[..., ~upper], want[..., ~upper], **TOL)


@pytest.mark.parametrize("s,final", [(64, False), (64, True), (36, True),
                                     (37, False), (7, True)])
def test_ssd_chunked_matches_jax(s, final):
    """The chunked dual form at chunk 32: lengths that divide it (64: two
    chunks), that take its largest divisor below it (36: chunks of 18; 37,
    a prime: chunks of 1) and shorter than it (7: one chunk), with and
    without the final state, at 1e-5."""
    jm, _, _, tm, _, _ = _pair()
    b, h, hd, hs = 2, 8, 16, 16
    x = _x((b, s, h, hd), 1)
    dt = np.abs(_x((b, s, h), 2)) * 0.1
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm, cm = _x((b, s, 1, hs), 3), _x((b, s, 1, hs), 4)
    want = jax.jit(functools.partial(jm._ssd_chunked, return_final=final))(
        *(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    got = tm._ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, bm, cm)),
                          return_final=final)
    if final:
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert got[1].dtype == torch.float32
    else:
        _close(got, want)
    assert tmamba2.ssd_chunk(s, 32) == {64: 32, 36: 18, 37: 1, 7: 7}[s]


def test_chunk_rule_falls_back_to_the_largest_divisor():
    """The largest divisor not above the chunk, as the JAX package's
    ``_ssd_chunked`` takes it: at mamba2-1.3b's chunk of 256 a 16384-token
    wave runs 64 chunks of 256, a 5008-token one 313 chunks of 16."""
    assert tmamba2.ssd_chunk(16384, 256) == 256
    assert tmamba2.ssd_chunk(5008, 256) == 16 and 5008 // 16 == 313
    assert tmamba2.ssd_chunk(512, 256) == 256
    assert tmamba2.ssd_chunk(300, 256) == 150


@pytest.mark.parametrize("lengths", [None, (40, 9, 33)])
def test_layer_matches_jax(lengths):
    """The block over a 40-token sequence (two chunks and a half at chunk
    16), without lengths and with a right-padded wave whose decode-ready
    SSM state and conv window it returns, then one recurrent step from
    those states, at 1e-5."""
    jm, base, peft, tm, tbase, tpeft = _pair(ssm_chunk=16)
    lp, la = _layer0(base), _layer0(peft.tree)
    tlp = layer_tree(tbase["layers"], 0)
    tla = layer_tree(adapter_subtree(tpeft, "layers"), 0)
    x = _x((3, 40, 64))
    lens = None if lengths is None else np.array(lengths, np.int32)
    jx, jst = jax.jit(functools.partial(jm._layer, lp, la))(
        jnp.asarray(x), prefill_lengths=None if lens is None
        else jnp.asarray(lens))
    tx, tst = tm._layer(tlp, tla, torch.from_numpy(x),
                        prefill_lengths=None if lens is None
                        else torch.from_numpy(lens))
    _close(tx, jx)
    if lens is None:
        assert jst is None and tst is None
        return
    for g, w in zip(tst, jst):
        _close(g, w)
    step = _x((3, 1, 64), seed=1)
    jy, (js, jc) = jax.jit(functools.partial(jm._layer, lp, la))(
        jnp.asarray(step), cache=jst)
    ty, (ts, tc) = tm._layer(tlp, tla, torch.from_numpy(step), cache=tst)
    for g, w in ((ty, jy), (ts, js), (tc, jc)):
        _close(g, w)


def test_chunked_prefill_equals_the_recurrence():
    """Over a prompt of several chunks (70 tokens at chunk 8, and one of
    13 padded beside it) the chunked prefill's last logits and decode
    cache equal those of stepping the same tokens through the recurrence
    from an empty cache (1e-4), and the greedy tokens that follow are
    equal; the logits also match the JAX model's prefill."""
    jm, base, peft, tm, tbase, tpeft = _pair(ssm_chunk=8)
    toks = _tokens(2, 70)
    lens = np.array([70, 13], np.int32)
    lj, _ = jax.jit(jm.prefill)(base, peft, {"tokens": jnp.asarray(toks)},
                                lengths=jnp.asarray(lens))
    lt, ct = tm.prefill(tbase, tpeft, {"tokens": torch.from_numpy(toks)},
                        lengths=torch.from_numpy(lens))
    _close(lt, lj, rtol=1e-4, atol=1e-4)
    cr = tm.init_cache(2, 70)
    step_logits = []
    for t in range(70):
        lr, cr = tm.decode_step(tbase, tpeft, cr,
                                {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        step_logits.append(lr)
        if t == 12:       # the short row's state at its last token
            short = {k: v[:, 1].clone() for k, v in cr.items()
                     if k != "len"}
    _close(lt[0, 0, :256], step_logits[69][0, 0, :256], rtol=1e-4,
           atol=1e-4)
    _close(lt[1, 0, :256], step_logits[12][1, 0, :256], rtol=1e-4,
           atol=1e-4)
    _close(ct["ssm"][:, 0], cr["ssm"][:, 0], rtol=1e-4, atol=1e-4)
    _close(ct["ssm"][:, 1], short["ssm"], rtol=1e-4, atol=1e-4)
    _close(ct["conv"][:, 1], short["conv"], rtol=1e-4, atol=1e-4)
    # greedy continuation of row 0 from each cache
    nxt_c = nxt_r = lt[0:1, :, :256].argmax(-1)
    cc = {k: (v[:, :1].clone() if k != "len" else v[:1].clone())
          for k, v in ct.items()}
    cr = {k: (v[:, :1].clone() if k != "len" else v[:1].clone())
          for k, v in cr.items()}
    got, want = [], []
    for _ in range(8):
        l1, cc = tm.decode_step(tbase, tpeft, cc, {"tokens": nxt_c})
        l2, cr = tm.decode_step(tbase, tpeft, cr, {"tokens": nxt_r})
        nxt_c, nxt_r = l1[..., :256].argmax(-1), l2[..., :256].argmax(-1)
        got.append(int(nxt_c))
        want.append(int(nxt_r))
    assert got == want


def test_forward_and_loss_match_jax():
    """Forward logits at 1e-4 (over three chunks and a half at chunk 8),
    the loss (through the per-layer checkpoint) and its gradient on every
    QuanTA tensor at 1e-4; the base takes no gradient."""
    jm, base, peft, tm, tbase, tpeft = _pair(ssm_chunk=8)
    toks = _tokens(2, 28)
    lj, _ = jax.jit(jm.forward)(base, {"tokens": jnp.asarray(toks)}, peft)
    lt, aux = tm.forward(tbase, {"tokens": torch.from_numpy(toks)}, tpeft)
    _close(lt, lj, rtol=1e-4, atol=1e-4)
    assert aux == 0.0
    last, _ = tm.forward(tbase, {"tokens": torch.from_numpy(toks)}, tpeft,
                         last_only=True)
    _close(last[:, 0], lt[:, -1])
    rng = np.random.RandomState(6)
    batch = {"tokens": rng.randint(0, 256, (2, 24)).astype(np.int32),
             "labels": rng.randint(0, 256, (2, 24)).astype(np.int32)}
    batch["labels"][0, :3] = -100
    tm = build_model(get_smoke(ARCH).replace(ssm_chunk=8), device="cpu")
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


def test_weights_and_adapters_carry_over():
    """Every weight carries over by a plain copy; QuanTA attaches at the
    config's three kinds of path (x_proj, z_proj: d -> 2d; out_proj: 2d ->
    d), a bank over them holds them, and the merged weights equal the JAX
    package's."""
    params, base, peft = _jax_weights()
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    jflat = flatten_paths(jax.tree_util.tree_map(np.asarray, base))
    tflat = flatten_paths(tbase)
    assert sorted(jflat) == sorted(tflat)
    for path, w in jflat.items():
        np.testing.assert_array_equal(tflat[path].numpy(), w)
    tpeft = interop.adapter_set_from_numpy(peft, "cpu")
    assert sorted(tpeft.paths) == ["layers/out_proj", "layers/x_proj",
                                   "layers/z_proj"]
    shapes = {s.path: (s.d_in, s.d_out) for s in tpeft.specs}
    assert shapes == {"layers/x_proj": (64, 128), "layers/z_proj": (64, 128),
                      "layers/out_proj": (128, 64)}
    tparams = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    bank = AdapterBank.build(tparams, {"t": (tbase, tpeft)})
    assert sorted(flatten_paths(bank.tree)) == sorted(tpeft.paths)
    merged = merge_all(tbase, tpeft)
    jmerged = flatten_paths(jax.tree_util.tree_map(
        np.asarray, j_merge_all(base, peft)))
    for path in tpeft.paths:
        _close(flatten_paths(merged)[path], jmerged[path])


def test_init_has_the_jax_leaves():
    """The port's own random init: the JAX package's leaves, shapes and
    dtypes, and its constant leaves' values."""
    cfg = get_smoke(ARCH)
    tparams = build_model(cfg, device="cpu").init(0)
    jparams = j_build_model(j_get_smoke(ARCH)).init(jax.random.PRNGKey(0))
    jflat = flatten_paths(jax.tree_util.tree_map(np.asarray, jparams))
    tflat = flatten_paths(tparams)
    assert sorted(jflat) == sorted(tflat)
    for path, w in jflat.items():
        assert tuple(tflat[path].shape) == w.shape, path
        assert tflat[path].dtype == torch.float32
    for path in ("layers/dt_bias", "layers/a_log", "layers/d_skip",
                 "layers/gate_norm", "layers/conv_b", "layers/ln",
                 "final_norm"):
        _close(tflat[path], jflat[path], rtol=1e-6, atol=1e-6)


def test_build_model_gives_mamba2_with_an_o1_cache():
    """``build_model`` gives Mamba2 for the SSM family, with no chunk
    step; its cache has no token axis (``max_len`` does not size it) and
    no paged leaf."""
    tm = build_model(get_smoke(ARCH), device="cpu")
    assert isinstance(tm, Mamba2) and not hasattr(tm, "prefill_chunk")
    small = tm.init_cache(3, 16, device="meta")
    big = tm.init_cache(3, 100_000, device="meta")
    assert {k: tuple(v.shape) for k, v in small.items()} == {
        k: tuple(v.shape) for k, v in big.items()} == {
        "ssm": (2, 3, 8, 16, 16), "conv": (2, 3, 3, 160), "len": (3,)}
    assert small["ssm"].dtype == torch.float32
    assert all(type(ls).__name__ == "CacheLeafSpec"
               for ls in tm.cache_spec().values())


def test_merged_matches_adapted():
    """The merged weights give the adapted model's logits (f32, 1e-4 of
    the largest): the chain on x_proj, z_proj and out_proj folds into the
    weights it adapts."""
    _, _, _, tm, tbase, tpeft = _pair()
    merged = merge_all(tbase, tpeft)
    toks = torch.from_numpy(_tokens(2, 30))
    la, _ = tm.forward(tbase, {"tokens": toks}, tpeft)
    lm, _ = tm.forward(merged, {"tokens": toks}, None)
    assert float((la - lm).abs().max()) <= 1e-4 * float(lm.abs().max())
    base_only, _ = tm.forward(tbase, {"tokens": toks}, None)
    assert float((la - base_only).abs().max()) > 1e-2 * float(
        lm.abs().max())
