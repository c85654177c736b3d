"""The port's optimizer substrate held against the JAX package on the same
numpy inputs: one AdamW update (with and without decay, clipped and not)
to 1e-6, the three schedules at steps 0-50 to 1e-7, int8 compression
(codes exact, scales to 1e-7) and three rounds of error feedback.

Tensor results are held elementwise at ``rtol`` plus ``rtol`` times the
leaf's largest magnitude: the global norm of a clipped update sums in
another order than XLA's (1.2e-7 apart here), and an updated parameter
near zero (``p - lr * delta`` cancelling) magnifies that relative to its
own size.  Unclipped updates agree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro.optim import schedules as JS
from repro_torch.core.adapters import tree_leaves
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC
from repro_torch.optim import schedules as TS

RTOL = 1e-6


def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {
        "layers": {"a": (scale * rs.standard_normal((3, 8, 5))
                         ).astype(np.float32),
                   "b": (scale * rs.standard_normal((7,))).astype(np.float32)},
        "head": (scale * rs.standard_normal((4, 6))).astype(np.float32),
    }


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(t_tree, j_tree, rtol=RTOL):
    j_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(j_tree)]
    # jax flattens dicts in sorted key order, the port in insertion order
    t_sorted = [x.numpy() for x in _sorted_leaves(t_tree)]
    assert len(j_leaves) == len(t_sorted) == len(tree_leaves(t_tree))
    for t, j in zip(t_sorted, j_leaves):
        np.testing.assert_allclose(t, j, rtol=rtol,
                                   atol=rtol * float(np.abs(j).max()))


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("max_grad_norm", [None, 1.0, 100.0])
def test_adamw_update_matches_jax(weight_decay, max_grad_norm):
    params, grads = _tree(0), _tree(1, scale=3.0)
    kw = dict(lr=5e-3, weight_decay=weight_decay,
              max_grad_norm=max_grad_norm)
    jopt, topt = JA.AdamW(**kw), TA.AdamW(**kw)
    jst, tst = jopt.init(_jax(params)), topt.init(_torch(params))
    jp, tp = _jax(params), _torch(params)
    # two updates: the second starts from non-zero moments
    for g in (grads, _tree(2, scale=0.5)):
        jp, jst = jopt.update(_jax(g), jst, jp)
        tp, tst = topt.update(_torch(g), tst, tp)
        _close(tp, jp)
        _close(tst.mu, jst.mu)
        _close(tst.nu, jst.nu)
        assert tst.step == int(jst.step)


def test_adamw_leaves_its_arguments_alone():
    params, grads = _torch(_tree(0)), _torch(_tree(1))
    before = [t.clone() for t in tree_leaves(params)]
    opt = TA.AdamW(lr=1e-2)
    state = opt.init(params)
    new, _ = opt.update(grads, state, params)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    assert not any(torch.equal(a, b) for a, b in zip(before,
                                                     tree_leaves(new)))


def test_adamw_with_a_schedule_matches_jax():
    params, grads = _tree(3), _tree(4)
    jopt = JA.AdamW(lr=JS.linear_warmup_schedule(1e-2, 10, 3))
    topt = TA.AdamW(lr=TS.linear_warmup_schedule(1e-2, 10, 3))
    jp, tp = _jax(params), _torch(params)
    jst, tst = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        jp, jst = jopt.update(_jax(grads), jst, jp)
        tp, tst = topt.update(_torch(grads), tst, tp)
    _close(tp, jp)


def test_global_norm_and_clip_match_jax():
    g = _tree(5, scale=2.0)
    np.testing.assert_allclose(float(TA.global_norm(_torch(g))),
                               float(JA.global_norm(_jax(g))), rtol=RTOL)
    tc, tn = TA.clip_by_global_norm(_torch(g), 0.5)
    jc, jn = JA.clip_by_global_norm(_jax(g), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    _close(tc, jc)
    assert float(TA.global_norm({})) == 0.0


SCHEDULES = [
    ("constant", (3e-4,), {}),
    ("linear_warmup", (5e-3, 40, 7), {}),
    ("linear_warmup", (1e-3, 50), {}),
    ("wsd", (2e-3, 50, 5, 20), {}),
    ("wsd", (2e-3, 50, 5, 20), {"floor": 0.1}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES)
def test_schedules_match_jax(name, args, kw):
    jfn = getattr(JS, f"{name}_schedule")(*args, **kw)
    tfn = getattr(TS, f"{name}_schedule")(*args, **kw)
    for step in range(51):
        got = tfn(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(jfn(jnp.int32(step))),
                                   rtol=1e-7, atol=0)


@pytest.mark.parametrize("shape,scale", [((257,), 1.0), ((6, 33), 1e-3),
                                         ((4, 4), 0.0)])
def test_compress_int8_matches_jax(shape, scale):
    x = (scale * np.random.RandomState(6).standard_normal(shape)
         ).astype(np.float32)
    jq, js = JC.compress_int8(jnp.asarray(x))
    tq, ts = TC.compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7, atol=0)
    np.testing.assert_allclose(TC.decompress_int8(tq, ts).numpy(),
                               np.asarray(JC.decompress_int8(jq, js)),
                               rtol=1e-7, atol=0)


def test_error_feedback_rounds_match_jax():
    jst = JC.ef_init(_jax(_tree(0)))
    tst = TC.ef_init(_torch(_tree(0)))
    for r in range(3):
        g = _tree(10 + r, scale=0.1 * (r + 1))
        jg, jst = JC.ef_compress_grads(_jax(g), jst)
        tg, tst = TC.ef_compress_grads(_torch(g), tst)
        _close(tg, jg, rtol=1e-7)
        _close(tst.error, jst.error, rtol=1e-5)
