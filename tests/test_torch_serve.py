"""The port's ServingEngine on the CPU generates token for token what the
JAX package's ServingEngine (dense cache, prefill admission) generates for
the prompts of examples/serve_batched.py, for the adapted and the merged
model (qwen2-0.5b SMOKE with perturbed QuanTA on q/v), and for the adapted
yi-6b, phi3-medium-14b and minicpm-2b SMOKE models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import (
    PeftConfig as JPeftConfig, attach as j_attach, merge_all as j_merge_all,
)
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest, ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.peft import merge_all
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.serve import Request, ServingEngine

PROMPTS = [[3, 141, 59], [26, 5], [35, 89, 79, 32], [38, 46], [2, 7, 18]]


@pytest.fixture(scope="module")
def jax_side():
    cfg = j_get_smoke("qwen2-0.5b")
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    base, peft = j_attach(jax.random.PRNGKey(1), params,
                          JPeftConfig(method="quanta", n_axes=3))
    rs = np.random.RandomState(3)
    peft = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), peft)
    merged = j_merge_all(base, peft)
    outs = {}
    for name, (p, a) in {"adapted": (base, peft),
                         "merged": (merged, None)}.items():
        eng = JEngine(model, p, a, n_slots=4, max_len=64,
                      admission="prefill")
        reqs = [JRequest(uid=i, prompt=list(q), max_new_tokens=8)
                for i, q in enumerate(PROMPTS)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs[name] = [r.output for r in reqs]
    return base, peft, outs


def _serve(model, params, peft):
    eng = ServingEngine(model, params, peft, n_slots=4, max_len=64,
                        device="cpu")
    reqs = [Request(uid=i, prompt=list(q), max_new_tokens=8)
            for i, q in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], eng.stats


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("which", ["adapted", "merged"])
def test_tokens_match_jax_engine(jax_side, which, backend):
    base, peft, outs = jax_side
    cfg = get_smoke("qwen2-0.5b").replace(attn_backend=backend,
                                          peft_backend=backend)
    model = build_model(cfg, device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    tpeft = interop.adapter_set_from_numpy(peft, "cpu")
    if which == "merged":
        tbase, tpeft = merge_all(tbase, tpeft), None
    before = launch_counts()
    got, stats = _serve(model, tbase, tpeft)
    assert got == outs[which]
    # 5 prompts over 4 slots: two prefill waves, 8 tokens each
    assert stats["prefill_calls"] == 2
    assert stats["tokens"] == 8 * len(PROMPTS)
    assert launch_counts() == before       # CPU tensors launch nothing


def _jax_adapted(arch):
    """JAX weights with perturbed QuanTA (the arch's n_axes) on q/v, and
    the JAX engine's tokens for PROMPTS."""
    model = j_build_model(j_get_smoke(arch))
    params = model.init(jax.random.PRNGKey(0))
    base, peft = j_attach(jax.random.PRNGKey(1), params, JPeftConfig(
        method="quanta", n_axes=get_peft(arch).n_axes))
    rs = np.random.RandomState(3)
    peft = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), peft)
    eng = JEngine(model, base, peft, n_slots=4, max_len=64,
                  admission="prefill")
    reqs = [JRequest(uid=i, prompt=list(q), max_new_tokens=8)
            for i, q in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return base, peft, [r.output for r in reqs]


@pytest.mark.parametrize("arch", ["yi-6b", "phi3-medium-14b", "minicpm-2b"])
def test_dense_family_tokens_match_jax_engine(arch):
    """GQA groups of 2 (yi-6b) and 4 (phi3-medium-14b), head_dim 18 and
    tied embeddings (minicpm-2b) through the kernel backend's wrappers
    (their plain versions on the CPU)."""
    base, peft, want = _jax_adapted(arch)
    model = build_model(get_smoke(arch).replace(
        attn_backend="pallas", peft_backend="pallas"), device="cpu")
    got, _ = _serve(model, interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu"),
        interop.adapter_set_from_numpy(peft, "cpu"))
    assert got == want


def test_engine_frees_and_reuses_slots():
    cfg = get_smoke("llama2-7b-proxy")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    eng = ServingEngine(model, params, n_slots=2, max_len=32, device="cpu")
    reqs = [Request(uid=i, prompt=[5 + i, 9], max_new_tokens=3)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.output) == 3 for r in reqs)
    assert eng.slots == [None, None]
    with pytest.raises(ValueError):
        eng.submit(Request(uid=9, prompt=list(range(40))))


@pytest.mark.parametrize("option", [
    pytest.param(dict(mesh=object()), id="option1"),
])
def test_unported_engine_options_raise(option):
    """``mesh=`` (once refused) takes a ``DeviceMesh``: anything else
    raises ``TypeError`` (the sharded engine itself is held in
    ``tests/test_torch_mesh.py``)."""
    model = build_model(get_smoke("llama2-7b-proxy"), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServingEngine(model, model.init(0), n_slots=2, max_len=32,
                      device="cpu", **option)


@pytest.mark.parametrize("adapters", [object(), {"layers": {}}])
def test_adapters_must_be_a_bank_or_pool(adapters):
    """``adapters=`` takes an ``AdapterBank`` or an ``AdapterPool`` only."""
    model = build_model(get_smoke("llama2-7b-proxy"), device="cpu")
    with pytest.raises(TypeError, match="AdapterBank or an AdapterPool"):
        ServingEngine(model, model.init(0), adapters=adapters, n_slots=2,
                      max_len=32, device="cpu")
