"""Fold-free QuanTA in the port (``PeftConfig(fold=False)``: the base is
left as it is and each adapter carries its frozen copy S), held against
the JAX package on the same numpy inputs: the attach leaves the base bit
for bit, ``delta``/``apply``/``merge`` and the model's logits agree at f32
1e-5, the kernel backend (plain versions on the CPU) takes two chain
calls, ``num_params`` counts T only, and S gets no gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import peft as JP
from repro.core import quanta as JQ
from repro.models import build_model as j_build_model
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.core import peft as TP
from repro_torch.core import quanta as TQ
from repro_torch.core.adapters import tree_leaves
from repro_torch.kernels import ops as tops
from repro_torch.kernels.quanta_apply import quanta_apply
from repro_torch.models import build_model

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _fold_free_pair(d_in, d_out, dims, seed=0):
    """A JAX fold-free adapter with T moved away from S, and the port's
    copy of it."""
    ja = JQ.QuantaAdapter.create(jax.random.PRNGKey(seed), d_in, d_out,
                                 dims_in=dims)
    rs = np.random.RandomState(seed + 1)
    t = tuple(x + jnp.asarray(0.05 * rs.standard_normal(x.shape), x.dtype)
              for x in ja.tensors)
    ja = JQ.QuantaAdapter(t, ja.dims_in, ja.dims_out, ja.pairs,
                          frozen=ja.tensors)
    return ja, interop.quanta_from_numpy(ja, "cpu")


@pytest.mark.parametrize("d_in,d_out,dims", [
    (64, 64, (4, 4, 4)), (24, 12, (4, 3, 2)), (128, 128, (8, 4, 2, 2)),
])
def test_delta_apply_merge_match_jax(d_in, d_out, dims):
    ja, ta = _fold_free_pair(d_in, d_out, dims)
    assert ta.fold_free and not ta.unfrozen().fold_free
    x = _x((5, 3, d_in))
    w = 0.1 * _x((d_in, d_out), seed=2)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(_np(ta.delta(tx)),
                               np.asarray(ja.delta(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(_np(ta.matrix()), np.asarray(ja.matrix()),
                               **TOL)
    np.testing.assert_allclose(_np(ta.merge(tw)),
                               np.asarray(ja.merge(jnp.asarray(w))), **TOL)
    for backend in ("reference", "pallas"):
        np.testing.assert_allclose(
            _np(ta.apply(tx, tw, backend)),
            np.asarray(ja.apply(jnp.asarray(x), jnp.asarray(w), backend)),
            **TOL)


def test_kernel_backend_runs_the_chain_twice(monkeypatch):
    """``backend="pallas"``: the base product plus one chain call for T and
    one for S (plain versions here), as the JAX adapter does."""
    _, ta = _fold_free_pair(64, 64, (4, 4, 4))
    calls = []
    real = tops.quanta_apply

    def counting(x, tensors, dims_in, pairs):
        calls.append([t for t in tensors])
        return real(x, tensors, dims_in, pairs)

    monkeypatch.setattr(tops, "quanta_apply", counting)
    x, w = torch.from_numpy(_x((7, 64))), torch.from_numpy(_x((64, 64), 3))
    got = ta.apply(x, w, "pallas")
    assert len(calls) == 2
    assert all(torch.equal(a, b) for a, b in zip(calls[0], ta.tensors))
    assert all(torch.equal(a, b) for a, b in zip(calls[1], ta.frozen))
    torch.testing.assert_close(got, ta.apply(x, w, "reference"), **TOL)
    assert torch.equal(
        quanta_apply(x, ta.tensors, ta.dims_in, ta.pairs),
        TQ.apply_sequential(x, ta.tensors, ta.dims_in, ta.pairs))


def _models(backend="reference"):
    jcfg = j_get_smoke("llama2-7b-proxy").replace(attn_backend=backend,
                                                  peft_backend=backend)
    tcfg = get_smoke("llama2-7b-proxy").replace(attn_backend=backend,
                                                peft_backend=backend)
    jm = j_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, build_model(tcfg, device="cpu")


def test_attach_leaves_the_base_and_counts_t_only():
    jm, params, tm = _models()
    tparams = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    base, peft = TP.attach(1, tparams, TP.PeftConfig(n_axes=4, fold=False),
                           device="cpu")
    flat_b, flat_p = TP.flatten_paths(base), TP.flatten_paths(tparams)
    assert flat_b.keys() == flat_p.keys()
    assert all(torch.equal(flat_b[k], flat_p[k]) for k in flat_p)
    for spec in peft.specs:
        assert not spec.fold
    _, folded = TP.attach(1, tparams, TP.PeftConfig(n_axes=4), device="cpu")
    for a, f in zip(peft.flat().values(), folded.flat().values()):
        assert a.frozen is not None and f.frozen is None
        # same draws: T equals the folded adapter's, and S is a copy of T
        assert all(torch.equal(t, u) for t, u in zip(a.tensors, f.tensors))
        assert all(torch.equal(t, s) and t.data_ptr() != s.data_ptr()
                   for t, s in zip(a.tensors, a.frozen))
        assert a.num_params == f.num_params == sum(
            t.numel() for t in a.tensors)
    assert peft.num_params == folded.num_params
    assert TP.trainable_fraction(base, peft) == pytest.approx(
        TP.trainable_fraction(base, folded))
    # the JAX count_params also counts S (ROADMAP queue 3): twice T
    jbase, jpeft = JP.attach(jax.random.PRNGKey(1), params, JP.PeftConfig(
        n_axes=4, fold=False))
    assert JP.count_params(jpeft) == 2 * interop.adapter_set_from_numpy(
        jpeft, "cpu").num_params
    # at step 0 the adapted model is the base model, bit for bit
    toks = np.random.RandomState(4).randint(0, 256, (2, 24)).astype(np.int32)
    la, _ = tm.forward(base, {"tokens": toks}, peft)
    lb, _ = tm.forward(base, {"tokens": toks}, None)
    assert torch.equal(la, lb)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_fold_free_model_matches_jax_and_its_folded_twin(backend):
    jm, params, tm = _models(backend)
    jbase, jpeft = JP.attach(jax.random.PRNGKey(1), params, JP.PeftConfig(
        n_axes=4, fold=False))
    rs = np.random.RandomState(2)
    for path, ad in jpeft.flat().items():
        node = jpeft.tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = JQ.QuantaAdapter(
            tuple(t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype) for t in ad.tensors),
            ad.dims_in, ad.dims_out, ad.pairs, frozen=ad.frozen)
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jbase), "cpu")
    tpeft = interop.adapter_set_from_numpy(jpeft, "cpu")
    assert all(not s.fold for s in tpeft.specs)
    toks = np.random.RandomState(4).randint(0, 256, (2, 40)).astype(np.int32)
    lj, _ = jm.forward(jbase, {"tokens": jnp.asarray(toks)}, jpeft)
    lt, _ = tm.forward(tbase, {"tokens": toks}, tpeft)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **TOL)
    # merged, as the JAX merge_all
    jm_merged = JP.merge_all(jbase, jpeft)
    tm_merged = TP.merge_all(tbase, tpeft)
    for k, v in TP.flatten_paths(tm_merged).items():
        np.testing.assert_allclose(
            _np(v), np.asarray(JP.flatten_paths(jm_merged)[k]), **TOL)
    # the folded twin from the same tensors: W0 - S as base, T as adapter
    twin_base = TP._copy_tree(tbase)
    twin_tree = {}
    for path, ad in tpeft.flat().items():
        w = TP.flatten_paths(tbase)[path]
        TP._set_path(twin_base, path, TP._per_layer(
            TQ.fold_frozen_copy, w, ad.unfrozen(ad.frozen)))
        TP._set_path(twin_tree, path, ad.unfrozen())
    lf, _ = tm.forward(twin_base, {"tokens": toks},
                       TP.AdapterSet(twin_tree, tpeft.specs))
    np.testing.assert_allclose(_np(lf), _np(lt), **TOL)


def test_frozen_copy_gets_no_gradient():
    _, ta = _fold_free_pair(64, 64, (4, 4, 4))
    t = [x.clone().requires_grad_(True) for x in ta.tensors]
    s = [x.clone().requires_grad_(True) for x in ta.frozen]
    ad = TQ.QuantaAdapter(tuple(t), ta.dims_in, ta.dims_out, ta.pairs,
                          frozen=tuple(s))
    x = torch.from_numpy(_x((6, 64))).requires_grad_(True)
    ad.delta(x).square().sum().backward()
    assert all(v.grad is not None for v in t) and x.grad is not None
    assert all(v.grad is None for v in s)
    assert len(tree_leaves(ad)) == 2 * len(t)


def test_bank_refuses_fold_free_tenants():
    """The bank refuses to serve a fold-free tenant as folded: given as
    the attach pair or as its adapter set alone, it banks bare, one
    delta-form group per path whose rows are the factors T and S (row 0
    all zeros), with no ``RebasedAdapter`` and no dense base copy."""
    from repro_torch.core.bank import AdapterBank

    m = build_model(get_smoke("llama2-7b-proxy"), device="cpu")
    params = m.init(0)
    tenant = TP.attach(1, params, TP.PeftConfig(n_axes=4, fold=False),
                       device="cpu")
    for entry in (tenant, tenant[1]):
        bank = AdapterBank.build(params, {"ff": entry})
        for path, node in TP.flatten_paths(bank.tree).items():
            assert node.delta_forms == (True,)
            (group,) = node.groups
            ad = tenant[1].flat()[path]
            assert type(group) is type(ad) and group.fold_free
            for g, t in zip(tree_leaves(group), tree_leaves(ad)):
                assert g.shape == (t.shape[0], 2) + t.shape[1:]
                assert not g[:, 0].any() and torch.equal(g[:, 1], t)
        assert bank.nbytes == sum(
            2 * t.numel() * 4 for t in tree_leaves(tenant[1])) + 2 * 2 * 4
