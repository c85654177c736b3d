"""The port's MoE family held against the JAX package on the same numpy
inputs: ``expert_capacity`` exactly, ``moe_ffn`` (output and aux loss at
f32 1e-5) over groups x top_k x no_drop x capacity factor with drops,
the top k of a tied router, and the mixtral-8x7b and
llama4-maverick-400b-a17b SMOKE Transformers (weights and perturbed
QuanTA from the JAX package through ``interop``): forward logits with
drops and the aux loss, prefill with lengths, decode (mixtral past its
48-token window), the loss and its gradients on the QuanTA tensors, and
decode against the no-drop full forward."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro.models.moe import (
    expert_capacity as j_expert_capacity, moe_ffn as j_moe_ffn,
)
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.adapters import tree_leaves, tree_map
from repro_torch.models import build_model
from repro_torch.models import moe

MOE = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]
TOL = dict(rtol=1e-4, atol=1e-4)
FFN_TOL = dict(rtol=1e-5, atol=1e-5)


def _ffn_params(e, d, ff, seed=1):
    rng = np.random.default_rng(seed)
    return {
        "router": (0.3 * rng.standard_normal((d, e))).astype(np.float32),
        "gate_proj": (rng.standard_normal((e, d, ff)) / math.sqrt(d)
                      ).astype(np.float32),
        "up_proj": (rng.standard_normal((e, d, ff)) / math.sqrt(d)
                    ).astype(np.float32),
        "down_proj": (rng.standard_normal((e, ff, d)) / math.sqrt(ff)
                      ).astype(np.float32),
    }


def _both(x, params, **kw):
    jo, ja = jax.jit(functools.partial(j_moe_ffn, **kw))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    to, ta = moe.moe_ffn(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in params.items()}, **kw)
    return (np.asarray(jo), float(ja)), (to.numpy(), float(ta))


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_expert_capacity_equals_jax(cf):
    for t in (1, 7, 8, 9, 16, 100, 256, 3072, 4600):
        for e in (4, 8, 128):
            for k in (1, 2):
                assert moe.expert_capacity(t, e, k, cf) == \
                    j_expert_capacity(t, e, k, cf), (t, e, k)


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("no_drop", [True, False])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_ffn_matches_jax(groups, top_k, no_drop, cf):
    """Output and aux loss at f32 1e-5; at capacity factor 0.5 without
    ``no_drop`` tokens are dropped (each expert holds at most half its
    fair share, so the output differs from the no-drop one), and
    ``no_drop`` ignores the factor."""
    e, d, ff = 4, 16, 32
    x = np.random.default_rng(0).standard_normal((4, 64, d)).astype(
        np.float32)
    params = _ffn_params(e, d, ff)
    kw = dict(n_experts=e, top_k=top_k, capacity_factor=cf,
              no_drop=no_drop, groups=groups)
    (jo, ja), (to, ta) = _both(x, params, **kw)
    np.testing.assert_allclose(to, jo, **FFN_TOL)
    np.testing.assert_allclose(ta, ja, **FFN_TOL)
    free, _ = moe.moe_ffn(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in params.items()},
        **dict(kw, no_drop=True))
    dropped = not np.allclose(to, free.numpy(), rtol=0, atol=1e-6)
    if no_drop or cf == 0.5:
        assert dropped == (not no_drop)


def test_groups_that_do_not_divide_fall_back_to_one():
    e, d, ff = 4, 8, 16
    x = np.random.default_rng(3).standard_normal((3, 5, d)).astype(
        np.float32)
    params = _ffn_params(e, d, ff, seed=4)
    kw = dict(n_experts=e, top_k=2, capacity_factor=0.5)
    (jo, ja), (to, ta) = _both(x, params, groups=4, **kw)
    np.testing.assert_allclose(to, jo, **FFN_TOL)
    one, _ = moe.moe_ffn(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in params.items()}, groups=1, **kw)
    np.testing.assert_array_equal(to, one.numpy())


@pytest.mark.parametrize("k", [1, 2, 3])
def test_tied_probabilities_pick_jax_experts(k):
    """Among equal probabilities the lower expert id comes first, as
    ``jax.lax.top_k`` picks: a zero router (every probability tied) and
    probabilities on a few levels (ties inside and across the top k)."""
    levels = np.random.default_rng(k).integers(0, 3, (64, 8))
    probs = (levels / levels.sum(-1, keepdims=True).clip(1)).astype(
        np.float32)
    probs[0] = 1 / 8
    jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
    gates, idx = moe.top_k_gates(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(idx[0].numpy(), np.arange(k))
    want = np.asarray(jv) / np.maximum(np.asarray(jv).sum(-1, keepdims=True),
                                       1e-9)
    np.testing.assert_allclose(gates.numpy(), want, rtol=1e-6)
    e, d = 8, 16
    params = _ffn_params(e, d, 24, seed=k)
    params["router"][:] = 0.0
    x = np.random.default_rng(9).standard_normal((2, 8, d)).astype(
        np.float32)
    (jo, ja), (to, ta) = _both(x, params, n_experts=e, top_k=k,
                               capacity_factor=1.25)
    np.testing.assert_allclose(to, jo, **FFN_TOL)
    assert ta == pytest.approx(ja, rel=1e-6)


# ------------------------------------------------------------ the models
@functools.lru_cache(maxsize=None)
def _jax_weights(arch):
    jm = j_build_model(j_get_smoke(arch))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    base, peft = jax.jit(lambda p: j_attach(
        jax.random.PRNGKey(1), p, JPeftConfig(
            method="quanta", n_axes=get_peft(arch).n_axes)))(params)
    rs = np.random.RandomState(3)
    peft = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), peft)
    return base, peft


def _pair(arch, backend="pallas", **cfg_kw):
    """(jax model, jax params, jax peft, port model, port params, port
    peft), the port on the kernel backends' wrappers (their plain versions
    on the CPU) unless ``backend`` says otherwise."""
    base, peft = _jax_weights(arch)
    jm = j_build_model(j_get_smoke(arch).replace(**cfg_kw))
    tm = build_model(get_smoke(arch).replace(
        attn_backend=backend, peft_backend=backend, **cfg_kw), device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    return jm, base, peft, tm, tbase, interop.adapter_set_from_numpy(
        peft, "cpu")


def _tokens(b, s, seed=4):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def test_moe_leaves_cross_by_a_plain_copy():
    """The router ``(L, d, E)`` and the 4-D expert stacks ``(L, E, d,
    ff)`` carry over as they are, and a carried train state keeps them
    frozen (no grad) on its device."""
    from repro.optim import AdamW as JAdamW
    from repro.train import TrainState as JState

    base, peft = _jax_weights("mixtral-8x7b")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    for key, shape in (("router", (2, 64, 4)), ("gate_proj", (2, 4, 64, 128)),
                       ("up_proj", (2, 4, 64, 128)),
                       ("down_proj", (2, 4, 128, 64))):
        got = tbase["layers"]["moe"][key]
        assert tuple(got.shape) == shape and got.device.type == "cpu"
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(base["layers"]["moe"][key]))
    state = interop.train_state_from_numpy(
        jax.jit(lambda b, p: JState.create(b, p, JAdamW(lr=5e-3)))(
            base, peft), "cpu")
    for t in tree_leaves(state.params["layers"]["moe"]):
        assert not t.requires_grad and t.grad is None
        assert t.device.type == "cpu"


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("arch", MOE)
def test_forward_and_aux_match_jax(arch, cf):
    """The training dispatch (the config's capacity factor, and 0.5, at
    which tokens drop) and the aux loss summed over layers."""
    kw = {} if cf is None else dict(capacity_factor=cf)
    jm, base, peft, tm, tbase, tpeft = _pair(arch, **kw)
    toks = _tokens(2, 40)
    lj, aj = jax.jit(jm.forward)(base, {"tokens": jnp.asarray(toks)}, peft)
    lt, at = tm.forward(tbase, {"tokens": torch.from_numpy(toks)}, tpeft)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    assert float(at) > 0
    if cf is not None:
        free, _ = _pair(arch, capacity_factor=4.0)[3].forward(
            tbase, {"tokens": torch.from_numpy(toks)}, tpeft)
        assert not torch.allclose(free, lt, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(arch):
    """A prefill wave with lengths (no drops), landed in a serving cache,
    then 12 decode steps: mixtral's rows run past its 48-token window."""
    jm, base, peft, tm, tbase, tpeft = _pair(arch)
    toks = _tokens(3, 40)
    lens = np.array([40, 23, 37], np.int32)
    lj, cj = jax.jit(jm.prefill)(base, peft, {"tokens": jnp.asarray(toks)},
                                 lengths=jnp.asarray(lens))
    lt, ct = tm.prefill(tbase, tpeft, {"tokens": torch.from_numpy(toks)},
                        lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]), **TOL)
    jc = jm.insert_cache(jm.init_cache(4, 64), np.array([2, 0, 1]), cj)
    tc = tm.insert_cache(tm.init_cache(4, 64), np.array([2, 0, 1]), ct)
    nxt = _tokens(4, 1, seed=5)
    decode = jax.jit(lambda c, t: jm.decode_step(base, peft, c,
                                                 {"tokens": t}))
    for _ in range(12):
        lj, jc = decode(jc, jnp.asarray(nxt))
        lt, tc = tm.decode_step(tbase, tpeft, tc,
                                {"tokens": torch.from_numpy(nxt)})
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        nxt = np.array(jnp.argmax(lj, -1), np.int32)
    assert max(tc["len"].tolist()) == 52


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_adapter_grads_match_jax(arch):
    """The loss (cross entropy plus ``router_aux_weight`` times the aux
    loss, through the per-layer checkpoint) and its gradient on every
    QuanTA tensor at 1e-4; the frozen router and experts take none."""
    jm, base, peft, tm, tbase, tpeft = _pair(arch)
    rng = np.random.RandomState(6)
    batch = {"tokens": rng.randint(0, 256, (2, 24)).astype(np.int32),
             "labels": rng.randint(0, 256, (2, 24)).astype(np.int32)}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(base, p, {
        k: jnp.asarray(v) for k, v in batch.items()})))(peft)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(tpeft)]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), tpeft)
    tl = tm.loss(tbase, tree, batch)
    with torch.no_grad():
        assert float(tm._hidden(tbase, batch, tree)[1]) > 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, leaves)
    want = tree_leaves(interop.adapter_set_from_numpy(jg, "cpu"))
    assert len(want) == len(grads) > 0
    for got, w in zip(grads, want):
        assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert not any(t.requires_grad or t.grad is not None
                   for t in tree_leaves(tbase))


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_no_drop_full_forward(arch):
    """With capacity drops removed the training forward equals token by
    token decoding, as the JAX package's test_decode_matches_full_forward
    holds its MoE model (mixtral's 48 steps reach its window)."""
    cfg = get_smoke(arch)
    cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    tm = build_model(cfg, device="cpu")
    params = tm.init(1)
    s = 48
    toks = torch.from_numpy(_tokens(2, s, seed=2).astype(np.int64))
    full, _ = tm.forward(params, {"tokens": toks})
    cache = tm.init_cache(2, s)
    outs = []
    for t in range(s):
        lg, cache = tm.decode_step(params, None, cache,
                                   {"tokens": toks[:, t:t + 1]})
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    v = cfg.vocab_size
    np.testing.assert_allclose(full[..., :v].numpy(), dec[..., :v].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_init_draws_expert_stacks_in_param_dtype():
    cfg = get_smoke("llama4-maverick-400b-a17b").replace(
        param_dtype=torch.bfloat16)
    params = build_model(cfg, device="cpu").init(0)
    m = params["layers"]["moe"]
    assert tuple(m["router"].shape) == (2, 64, 8)
    assert tuple(m["gate_proj"].shape) == (2, 8, 64, 96)
    assert tuple(m["down_proj"].shape) == (2, 8, 96, 64)
    assert all(t.dtype == torch.bfloat16 for t in m.values())
    assert "mlp" not in params["layers"]
    # expert by expert: no two experts share their draw
    g = m["gate_proj"].float()
    assert not torch.equal(g[0, 0], g[0, 1])
    assert float(g.std()) == pytest.approx(64 ** -0.5, rel=0.1)
