"""The port's train step held against the JAX package's on the SMOKE
llama2-7b-proxy config (f32, CPU): weights and adapters carried over
through ``interop``, the same ``SyntheticSeq2Task`` batches (the port's
copy of the data pipeline), AdamW at lr 5e-3.  Losses and grad norms agree
to 1e-4 relative at every step over 10 steps (reference attention, and
kernel 3's Function on its plain version against the JAX kernel in
interpret mode); a JAX state carried in after 5 steps and run 5 more in
the port ends where JAX's 10-step run ends; microbatches, fold-free
QuanTA, ``full_ft`` and int8 compression run 3 steps against JAX; two
steps on each of the yi-6b, phi3-medium-14b and minicpm-2b SMOKE configs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.data import SyntheticSeq2Task as JTask
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro.train import TrainState as JState, make_train_step as j_step
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.core.adapters import tree_leaves
from repro_torch.data import SyntheticSeq2Task
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.train import TrainState, make_eval_step, make_train_step

RTOL = 1e-4


def _setup(backend="reference", fold=True, method="quanta",
           arch="llama2-7b-proxy", **peft_kw):
    jcfg = j_get_smoke(arch).replace(attn_backend=backend)
    jm = j_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    if method == "ft":
        base, peft = params, {}
    else:
        base, peft = j_attach(jax.random.PRNGKey(1), params, JPeftConfig(
            method=method, n_axes=3, fold=fold, **peft_kw))
    tm = build_model(get_smoke(arch).replace(
        attn_backend=backend), device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    tpeft = interop.adapter_set_from_numpy(peft, "cpu") if peft else {}
    return jm, base, peft, tm, tbase, tpeft


def _data():
    kw = dict(vocab_size=256, seq_len=32, global_batch=16, task_rank=8)
    return JTask(**kw), SyntheticSeq2Task(**kw)


def _jax_run(jm, base, peft, steps, first=0, state=None, **kw):
    opt = JAdamW(lr=5e-3)
    full_ft = kw.get("full_ft", False)
    if state is None:
        state = JState.create(base, peft, opt,
                              compress=kw.get("compress", False),
                              full_ft=full_ft)
    step = jax.jit(j_step(jm, opt, **kw))
    data, _ = _data()
    out = []
    for i in range(first, first + steps):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data.batch(i).items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, state


def _torch_run(tm, tbase, tpeft, steps, first=0, state=None, **kw):
    opt = AdamW(lr=5e-3)
    if state is None:
        state = TrainState.create(tbase, tpeft, opt,
                                  compress=kw.get("compress", False),
                                  full_ft=kw.get("full_ft", False))
    step = make_train_step(tm, opt, **kw)
    _, data = _data()
    out = []
    for i in range(first, first + steps):
        state, m = step(state, data.batch(i))
        assert m["step"] == i + 1
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, state


def _agree(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=rtol)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_ten_steps_match_jax(backend):
    jm, base, peft, tm, tbase, tpeft = _setup(backend)
    want, _ = _jax_run(jm, base, peft, 10)
    got, state = _torch_run(tm, tbase, tpeft, 10)
    _agree(got, want)
    assert got[-1][0] < got[0][0]
    # the base was never touched, and took no gradient
    for a, b in zip(tree_leaves(state.params), tree_leaves(tbase)):
        assert a is b and not a.requires_grad and a.grad is None


@pytest.mark.parametrize("arch", ["yi-6b", "phi3-medium-14b",
                                  "minicpm-2b"])
def test_two_steps_match_jax_on_the_dense_family(arch):
    """Two AdamW steps of QuanTA (3 axes) on the SMOKE configs of the rest
    of the dense family, kernel 3's Function on its plain version (GQA
    groups of 2 and 4; minicpm-2b's head_dim 18 and tied embeddings)."""
    jm, base, peft, tm, tbase, tpeft = _setup("pallas", arch=arch)
    want, _ = _jax_run(jm, base, peft, 2)
    got, state = _torch_run(tm, tbase, tpeft, 2)
    _agree(got, want)
    for a, b in zip(tree_leaves(state.params), tree_leaves(tbase)):
        assert a is b and not a.requires_grad and a.grad is None


def test_jax_state_continues_in_the_port():
    jm, base, peft, tm, _, _ = _setup()
    want, jfinal = _jax_run(jm, base, peft, 10)
    first, jstate = _jax_run(jm, base, peft, 5)
    tstate = interop.train_state_from_numpy(jstate, "cpu")
    assert tstate.step == tstate.opt_state.step == 5
    got, tfinal = _torch_run(tm, None, None, 5, first=5, state=tstate)
    _agree(first + got, want)
    final = tree_leaves(interop.adapter_set_from_numpy(jfinal.peft, "cpu"))
    for a, b in zip(tree_leaves(tfinal.peft), final):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=RTOL * float(b.abs().max()))


def test_microbatches_equal_one_batch():
    jm, base, peft, tm, tbase, tpeft = _setup()
    one, s1 = _torch_run(tm, tbase, tpeft, 3)
    two, s2 = _torch_run(tm, tbase, tpeft, 3, microbatches=2)
    _agree(two, one, rtol=1e-5)
    for a, b in zip(tree_leaves(s1.peft), tree_leaves(s2.peft)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    want, _ = _jax_run(jm, base, peft, 3, microbatches=2)
    _agree(two, want)
    with pytest.raises(ValueError, match="not divisible"):
        _torch_run(tm, tbase, tpeft, 1, microbatches=3)


@pytest.mark.parametrize("kind", ["fold_free", "full_ft", "compress"])
def test_variants_match_jax(kind):
    kw = {"full_ft": {"full_ft": True}, "compress": {"compress": True},
          "fold_free": {}}[kind]
    jm, base, peft, tm, tbase, tpeft = _setup(
        method="ft" if kind == "full_ft" else "quanta",
        fold=kind != "fold_free")
    want, _ = _jax_run(jm, base, peft, 3, **kw)
    got, state = _torch_run(tm, tbase, tpeft, 3, **kw)
    _agree(got, want)
    if kind == "fold_free":
        # S got zero gradients and zero updates
        for a, t in zip(state.peft.flat().values(), tpeft.flat().values()):
            assert all(torch.equal(x, y) for x, y in zip(a.frozen, t.frozen))
            assert not all(torch.equal(x, y)
                           for x, y in zip(a.tensors, t.tensors))
    if kind == "full_ft":
        assert state.peft == {}
        moved = [not torch.equal(a, b) for a, b in
                 zip(tree_leaves(state.params), tree_leaves(tbase))]
        assert all(moved)
    if kind == "compress":
        assert state.ef_state is not None
        assert any(float(e.abs().max()) > 0
                   for e in tree_leaves(state.ef_state.error))


def test_eval_step_and_the_kernel_backend_guard():
    _, _, _, tm, tbase, tpeft = _setup()
    opt = AdamW(lr=5e-3)
    state = TrainState.create(tbase, tpeft, opt)
    _, data = _data()
    loss = make_eval_step(tm)(state, data.batch(0))
    assert loss.grad_fn is None and float(loss) > 0
    kernel = build_model(tm.cfg.replace(peft_backend="pallas"),
                         device="cpu")
    with pytest.raises(ValueError, match="peft_backend='reference'"):
        make_train_step(kernel, opt)
