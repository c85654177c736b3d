"""The port's engine over the frontend models (SMOKE configs) against the
JAX engine: pixtral-12b is served text only, by replay over the dense
cache, as the JAX engine admits a model with a frontend under
``admission="auto"`` (and under ``prefill_chunk=``, which replay
ignores), with its greedy tokens equal to the JAX engine's on the
float32 base, an NF4 base and a LoRA bank.  Each refusal of the reference
holds on both sides: prefill admission, a paged cache and ``ServeFrontend``
for pixtral, and any engine over musicgen-large (its decode step reads
frame embeddings; the JAX engine raises ``KeyError: 'embeds'`` at its
first step, the port at construction).  10 AdamW steps of QuanTA on each
SMOKE config (frame embeddings; patches before text, labels over every
position) agree with the JAX train step at 1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core.bank import AdapterBank as JBank
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro.serve import (
    Request as JRequest, ServeFrontend as JFrontend, ServingEngine as JEngine,
)
from repro.train import TrainState as JState, make_train_step as j_step
from repro_torch import configs, interop
from repro_torch.core.adapters import tree_leaves
from repro_torch.core.bank import AdapterBank
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.serve import Request, ServeFrontend, ServingEngine
from repro_torch.train import TrainState, make_train_step

PIXTRAL, MUSICGEN = "pixtral-12b", "musicgen-large"
PROMPTS = [[3, 141, 59] * 5, [26, 5], [35, 89, 79, 32] * 3, [38, 46, 2],
           [200, 1, 9, 9, 40] * 2]
# path -> (engine options, bank of LoRA tenants)
PATHS = {
    "auto": (dict(), False),
    "chunk ignored": (dict(prefill_chunk=4), False),
    "nf4 base": (dict(base_quant="nf4"), False),
    "lora bank": (dict(), True),
}
TENANTS = ("la", None, "lb", "la", "lb")


@functools.lru_cache(maxsize=None)
def _jax_weights(arch):
    jm = j_build_model(jconfigs.get_smoke(arch))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    peft_cfg = configs.get_peft(arch)
    qbase, qset = jax.jit(lambda p: j_attach(
        jax.random.PRNGKey(1), p, JPeftConfig(
            method="quanta", n_axes=peft_cfg.n_axes,
            targets=peft_cfg.targets)))(params)
    rs = np.random.RandomState(3)
    qset = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), qset)
    lora_attach = jax.jit(lambda key, p: j_attach(key, p, JPeftConfig(
        method="lora", rank=4, targets=peft_cfg.targets))[1])
    lora = []
    for key in (2, 5):
        lset = lora_attach(jax.random.PRNGKey(key), params)
        lora.append(jax.tree_util.tree_map(
            lambda t: t + jnp.asarray(0.15 * rs.standard_normal(t.shape),
                                      t.dtype), lset))
    return params, qbase, qset, lora


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run(eng, make, bank):
    reqs = [make(uid=i, prompt=list(p), max_new_tokens=6)
            for i, p in enumerate(PROMPTS)]
    for i, r in enumerate(reqs):
        eng.submit(r, adapter=TENANTS[i] if bank else None)
    eng.run()
    assert all(r.done and len(r.output) == 6 for r in reqs)
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_run(path):
    opts, bank = PATHS[path]
    params, qbase, qset, lora = _jax_weights(PIXTRAL)
    jm = j_build_model(jconfigs.get_smoke(PIXTRAL))
    if bank:
        eng = JEngine(jm, params, adapters=JBank.build(
            params, {"la": lora[0], "lb": lora[1]}), n_slots=3, max_len=64,
            **opts)
    else:
        eng = JEngine(jm, qbase, qset, n_slots=3, max_len=64, **opts)
    assert eng.admission == "replay"
    return _run(eng, JRequest, bank), dict(eng.stats)


@pytest.mark.parametrize("path", list(PATHS))
def test_pixtral_engine_tokens_match_jax(path):
    """Replay admission under ``"auto"``: the JAX engine's greedy tokens,
    no prefill call on either side (``prefill_chunk=`` ignored: no chunk
    call either), the base packed under ``base_quant``."""
    opts, bank = PATHS[path]
    params, qbase, qset, lora = _jax_weights(PIXTRAL)
    tm = build_model(configs.get_smoke(PIXTRAL).replace(
        attn_backend="pallas", peft_backend="pallas"), device="cpu")
    if bank:
        tparams = interop.params_from_numpy(_np(params), "cpu")
        eng = ServingEngine(tm, tparams, adapters=AdapterBank.build(
            tparams, {"la": interop.tenant_from_numpy(lora[0], "cpu"),
                      "lb": interop.tenant_from_numpy(lora[1], "cpu")}),
            n_slots=3, max_len=64, device="cpu", **opts)
    else:
        eng = ServingEngine(tm, interop.params_from_numpy(_np(qbase), "cpu"),
                            interop.adapter_set_from_numpy(qset, "cpu"),
                            n_slots=3, max_len=64, device="cpu", **opts)
    assert eng.admission == "replay"
    got = _run(eng, Request, bank)
    want, jstats = _jax_run(path)
    assert got == want
    for key in ("prefill_calls", "chunk_calls"):
        assert eng.stats[key] == jstats[key] == 0
    assert eng.stats["decode_calls"] == jstats["decode_calls"]
    if path == "nf4 base":
        assert type(eng.params["layers"]["attn"]["q_proj"]).__name__ == (
            "QuantizedLinear")


def _engines(arch, **opts):
    """A port engine and a JAX engine over ``arch``'s SMOKE base (the JAX
    one only built: it raises at its first step where it fails)."""
    params = _jax_weights(arch)[0]
    tm = build_model(configs.get_smoke(arch), device="cpu")
    jm = j_build_model(jconfigs.get_smoke(arch))
    return (lambda: ServingEngine(
        tm, interop.params_from_numpy(_np(params), "cpu"), n_slots=2,
        max_len=32, device="cpu", **opts),
        lambda: JEngine(jm, params, n_slots=2, max_len=32, **opts))


@pytest.mark.parametrize("case", ["prefill", "paged", "frontend", "audio"])
def test_refusals_match_jax(case):
    """What the reference refuses, the port refuses: prefill admission
    and a paged cache (replay writes through dense stripes) for pixtral,
    ``ServeFrontend`` over its replay engine, and an engine over musicgen
    (the JAX engine feeds tokens to a decode step that reads frame
    embeddings and fails at its first step; the port says so at
    construction)."""
    if case == "audio":
        port, ref = _engines(MUSICGEN)
        with pytest.raises(ValueError, match="frame embeddings"):
            port()
        eng = ref()
        eng.submit(JRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
        with pytest.raises(KeyError, match="embeds"):
            eng.run()
        return
    if case == "frontend":
        port, ref = _engines(PIXTRAL)
        for make, fe in ((port, ServeFrontend), (ref, JFrontend)):
            with pytest.raises(ValueError, match="prefill admission"):
                fe(make())
        return
    opts = (dict(admission="prefill") if case == "prefill"
            else dict(cache="paged", block_size=8))
    match = ("cannot use prefill admission" if case == "prefill"
             else "replay admission writes through dense slot stripes")
    for make in _engines(PIXTRAL, **opts):
        with pytest.raises(ValueError, match=match):
            make()


def _train_batch(arch, i):
    """Batch ``i % 2`` of 4 rows of 32 positions (pixtral: 16 patches, 16
    tokens) with labels over every position."""
    cfg = configs.get_smoke(arch)
    rs = np.random.RandomState(20 + i % 2)
    b, s = 4, 32
    if cfg.frontend == "audio_tokens":
        batch = {"embeds": rs.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)}
    else:
        batch = {"patch_embeds": rs.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32),
            "tokens": rs.randint(0, 256, (b, s - cfg.n_patches)).astype(
                np.int32)}
    batch["labels"] = rs.randint(0, 256, (b, s)).astype(np.int32)
    return batch


@pytest.mark.parametrize("arch", [MUSICGEN, PIXTRAL])
def test_ten_train_steps_match_jax(arch):
    """10 AdamW steps of QuanTA on q/v (``make_train_step`` with 2
    microbatches, which split every leaf of the batch): loss and grad norm
    at 1e-4 against the JAX train step; the loss falls and the base never
    takes a gradient."""
    _, qbase, qset, _ = _jax_weights(arch)
    jm = j_build_model(jconfigs.get_smoke(arch))
    jopt, topt = JAdamW(lr=5e-3), AdamW(lr=5e-3)
    jstate = JState.create(qbase, qset, jopt)
    jstep = jax.jit(j_step(jm, jopt, microbatches=2))
    tm = build_model(configs.get_smoke(arch), device="cpu")
    tbase = interop.params_from_numpy(_np(qbase), "cpu")
    tstate = TrainState.create(tbase, interop.adapter_set_from_numpy(
        qset, "cpu"), topt)
    tstep = make_train_step(tm, topt, microbatches=2)
    want, got = [], []
    for i in range(10):
        batch = _train_batch(arch, i)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        tstate, tm_ = tstep(tstate, batch)
        want.append((float(jm_["loss"]), float(jm_["grad_norm"])))
        got.append((float(tm_["loss"]), float(tm_["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert got[-1][0] < got[0][0]
    assert sorted(tstate.peft.paths) == ["layers/attn/q_proj",
                                         "layers/attn/v_proj"]
    for a, b in zip(tree_leaves(tstate.params), tree_leaves(tbase)):
        assert a is b and not a.requires_grad and a.grad is None
