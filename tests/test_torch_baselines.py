"""The port's baseline adapters (``core/baselines.py``: LoRA, DoRA, DoTA,
KronA) held against the JAX package's: ``delta``, ``apply``, ``matrix``
(DoTA: ``tt_matrix``), ``merge``, ``neutral`` and ``num_params`` on the
same factors (made by the JAX package, perturbed off their zero init with
numpy noise, carried over as numpy), flat and layer-stacked; and the
port's own ``create`` starting at a zero update.

Tolerance: float32 at rtol/atol 1e-5 (products of a few dozen terms of
magnitude about 1, summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro_torch import interop
from repro_torch.core import baselines as TB
from repro_torch.core.adapters import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
D_IN, D_OUT = 48, 64
METHODS = ["lora", "dora", "dota", "krona"]
CHECKS = ["delta", "apply", "matrix", "merge", "neutral", "num_params"]


def _w(seed=0, shape=(D_IN, D_OUT)):
    return (np.random.RandomState(seed).standard_normal(shape) * 0.2
            ).astype(np.float32)


def _jax_adapter(method, seed=0):
    """A JAX adapter of ``method`` with every factor perturbed."""
    key = jax.random.PRNGKey(seed)
    w0 = jnp.asarray(_w())
    ja = {
        "lora": lambda: JB.LoraAdapter.create(key, D_IN, D_OUT, rank=4),
        "dora": lambda: JB.DoraAdapter.create(key, w0, rank=4),
        "dota": lambda: JB.DotaAdapter.create(key, w0, rank=2, n_axes=3),
        "krona": lambda: JB.KronaAdapter.create(key, D_IN, D_OUT, a_in=4,
                                                a_out=8, scale=0.5),
    }[method]()
    rs = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.1 * rs.standard_normal(t.shape),
                                  t.dtype), ja)


def _pair(method):
    ja = _jax_adapter(method)
    return ja, interop.adapter_from_numpy(ja, method, "cpu")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("method", METHODS)
def test_adapter_matches_jax(method, check):
    ja, ta = _pair(method)
    assert type(ta).__name__ == type(ja).__name__
    assert ta.delta_form == ja.delta_form == (method in ("lora", "krona"))
    x = np.random.RandomState(5).standard_normal((3, 2, D_IN)).astype(
        np.float32)
    w = _w(7)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    if check == "delta":
        if ta.delta_form:
            _close(ta.delta(tx), ja.delta(jx))
        else:
            with pytest.raises(NotImplementedError):
                ta.delta(tx)
    elif check == "apply":
        _close(ta.apply(tx, tw), ja.apply(jx, jw))
    elif check == "matrix":
        if method == "dota":
            _close(ta.tt_matrix(), ja.tt_matrix())
        elif ta.delta_form:
            _close(ta.matrix(), ja.matrix())
        else:
            with pytest.raises(NotImplementedError):
                ta.matrix()
    elif check == "merge":
        _close(ta.merge(tw), ja.merge(jw))
    elif check == "neutral":
        tn, jn = ta.neutral(tw), ja.neutral(jw)
        for t, j in zip(tree_leaves(tn), jax.tree_util.tree_leaves(jn)):
            _close(t, j)
        # apply against the same w is exactly the base product
        _close(tn.apply(tx, tw), jx @ jw)
        assert type(tn) is type(ta)
    else:
        assert ta.num_params == ja.num_params > 0


@pytest.mark.parametrize("method", METHODS)
def test_stacked_layer_view_matches_jax(method):
    """A layer-stacked adapter (two layers): ``layer(i)`` applies as the
    JAX package's vmapped slice does."""
    layers = [_jax_adapter(method, seed) for seed in (0, 3)]
    stacked = jax.tree_util.tree_map(lambda *t: jnp.stack(t), *layers)
    ta = interop.adapter_from_numpy(stacked, method, "cpu")
    x = np.random.RandomState(9).standard_normal((2, D_IN)).astype(
        np.float32)
    w = _w(11)
    for i, ja in enumerate(layers):
        _close(ta.layer(i).apply(torch.from_numpy(x), torch.from_numpy(w)),
               ja.apply(jnp.asarray(x), jnp.asarray(w)))
    assert ta.num_params == sum(a.num_params for a in layers)


@pytest.mark.parametrize("method", METHODS)
def test_port_create_starts_at_the_base(method):
    """``create`` with a ``torch.Generator`` draws the JAX package's shapes
    and starts at a zero update (DoRA/DoTA: ``m`` = column norms)."""
    gen = torch.Generator().manual_seed(0)
    w = torch.from_numpy(_w())
    ta = {
        "lora": lambda: TB.LoraAdapter.create(gen, D_IN, D_OUT, rank=4),
        "dora": lambda: TB.DoraAdapter.create(gen, w, rank=4),
        "dota": lambda: TB.DotaAdapter.create(gen, w, rank=2, n_axes=3),
        "krona": lambda: TB.KronaAdapter.create(gen, D_IN, D_OUT, a_in=4,
                                                a_out=8, scale=0.5),
    }[method]()
    ja = _jax_adapter(method)
    assert [tuple(t.shape) for t in tree_leaves(ta)] == [
        tuple(t.shape) for t in jax.tree_util.tree_leaves(ja)]
    assert ta.num_params == ja.num_params
    x = torch.randn(4, D_IN, generator=gen)
    torch.testing.assert_close(ta.apply(x, w), x @ w, **TOL)
    torch.testing.assert_close(ta.merge(w), w, **TOL)


def test_bottleneck_adapter_matches_jax():
    ja = JB.BottleneckAdapter.create(jax.random.PRNGKey(0), 16,
                                     bottleneck=4)
    rs = np.random.RandomState(1)
    ja = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.1 * rs.standard_normal(t.shape),
                                  t.dtype), ja)
    ta = TB.BottleneckAdapter(*(
        interop.tensor_from_numpy(t, "cpu")
        for t in (ja.down, ja.up, ja.bias_down, ja.bias_up)))
    h = rs.standard_normal((3, 16)).astype(np.float32)
    _close(ta(torch.from_numpy(h)), ja(jnp.asarray(h)))
    assert ta.num_params == ja.num_params
    gen = torch.Generator().manual_seed(0)
    fresh = TB.BottleneckAdapter.create(gen, 16, bottleneck=4)
    x = torch.randn(2, 16, generator=gen)
    assert torch.equal(fresh(x), x)
