"""Replay admission in the port (``ServingEngine(admission="replay")``),
held against the JAX package on the CPU: prompts stepped token by token
through the decode tick give the JAX replay engine's greedy tokens and
the prefill admission's (mirroring
``tests/test_serve_and_pipeline.py``'s admission-path test), with mixed
prompt lengths inside a wave and more requests than slots; a paged cache
refuses replay admission, as in the JAX package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke as j_get_smoke
from repro.core.bank import AdapterBank as JBank
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest, ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.bank import AdapterBank
from repro_torch.models import build_model
from repro_torch.serve import Request, ServingEngine

PROMPTS = [[5, 9, 13], [40, 2], [7, 7, 7, 7, 21, 3, 99], [100, 101],
           [1], [13, 5, 88, 4, 2], [250, 3, 17], [9] * 11]
ARCHS = ["llama2-7b-proxy", "qwen2-0.5b"]


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jm = j_build_model(j_get_smoke(arch))
    params = jm.init(jax.random.PRNGKey(0))
    base, peft = j_attach(jax.random.PRNGKey(1), params,
                          JPeftConfig(method="quanta",
                                      n_axes=get_peft(arch).n_axes))
    rs = np.random.RandomState(3)
    peft = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), peft)
    return jm, params, base, peft


def _run(eng, make, tenants=None):
    reqs = [make(uid=i, prompt=list(p), max_new_tokens=6)
            for i, p in enumerate(PROMPTS)]
    for i, r in enumerate(reqs):
        eng.submit(r, adapter=tenants[i] if tenants else None)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, mode):
    jm, _, base, peft = _weights(arch)
    eng = JEngine(jm, base, peft, n_slots=3, max_len=64, admission=mode)
    return _run(eng, JRequest), eng.stats["decode_calls"]


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_replay_matches_jax_and_prefill_admission(arch, backend):
    _, _, base, peft = _weights(arch)
    tm = build_model(get_smoke(arch).replace(attn_backend=backend,
                                             peft_backend=backend),
                     device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    tpeft = interop.adapter_set_from_numpy(peft, "cpu")
    outs = {}
    for mode in ("replay", "prefill"):
        eng = ServingEngine(tm, tbase, tpeft, n_slots=3, max_len=64,
                            admission=mode, device="cpu")
        outs[mode] = _run(eng, Request)
        want, j_ticks = _jax_tokens(arch, mode)
        assert outs[mode] == want, mode
        # replay steps every prompt token through the decode tick
        assert eng.stats["decode_calls"] == j_ticks
        assert eng.admission == mode
    assert outs["replay"] == outs["prefill"]


def test_replay_with_a_bank_matches_jax():
    """Replay admission over an AdapterBank (a QuanTA and a LoRA tenant
    and the base, mixed per request): the JAX bank engine's tokens."""
    arch = "qwen2-0.5b"
    jm, params, base, peft = _weights(arch)
    _, lora = j_attach(jax.random.PRNGKey(7), params,
                       JPeftConfig(method="lora", rank=4))
    lora = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(8), x.shape,
                                              x.dtype), lora)
    tenants = ["qa", "lo", None]
    tenants = [tenants[i % 3] for i in range(len(PROMPTS))]
    jeng = JEngine(jm, params, adapters=JBank.build(
        params, {"qa": (base, peft), "lo": lora}), n_slots=3, max_len=64,
        admission="replay")
    want = _run(jeng, JRequest, tenants)
    tm = build_model(get_smoke(arch), device="cpu")
    tparams = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    tbank = AdapterBank.build(tparams, {
        "qa": (interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, base), "cpu"),
            interop.adapter_set_from_numpy(peft, "cpu")),
        "lo": interop.adapter_set_from_numpy(lora, "cpu")})
    eng = ServingEngine(tm, tparams, adapters=tbank, n_slots=3, max_len=64,
                        admission="replay", device="cpu")
    assert _run(eng, Request, tenants) == want


def test_replay_refused_with_a_paged_cache_and_unknown_modes():
    tm = build_model(get_smoke("qwen2-0.5b"), device="cpu")
    params = tm.init(0)
    with pytest.raises(ValueError, match="replay admission writes through"):
        ServingEngine(tm, params, n_slots=2, max_len=32, cache="paged",
                      admission="replay", device="cpu")
    with pytest.raises(ValueError, match="unknown admission mode"):
        ServingEngine(tm, params, n_slots=2, max_len=32, admission="wave",
                      device="cpu")
    eng = ServingEngine(tm, params, n_slots=2, max_len=32, device="cpu")
    assert eng.admission == "prefill"       # "auto" with a prefill
