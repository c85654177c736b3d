"""The port's dense transformer held against the JAX package on the
llama2-7b-proxy and qwen2-0.5b SMOKE configs (forward, prefill and decode
also on yi-6b's, phi3-medium-14b's and minicpm-2b's: GQA groups of 2 and
4, head_dim 18 with tied embeddings): weights and the attached,
perturbed QuanTA adapters come from the JAX package through
``repro_torch.interop``; forward, prefill(lengths=) and decode_step
logits must agree at f32 1e-4, and the port's merged model must match its
adapted model at 1e-3 (as examples/quickstart.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core.peft import merge_all
from repro_torch.models import build_model

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch, backend):
    """(jax model, jax params, jax peft, port model, port params, port
    peft) with the same weights and perturbed adapters."""
    jcfg = j_get_smoke(arch).replace(attn_backend=backend,
                                     peft_backend=backend)
    tcfg = get_smoke(arch).replace(attn_backend=backend,
                                   peft_backend=backend)
    jm = j_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    base, peft = j_attach(jax.random.PRNGKey(1), params, JPeftConfig(
        method="quanta", n_axes=get_peft(arch).n_axes))
    rs = np.random.RandomState(2)

    def perturb(t):
        return t + jnp.asarray(0.05 * rs.standard_normal(t.shape), t.dtype)

    flat = peft.flat()
    for path, ad in flat.items():
        keys = path.split("/")
        node = peft.tree
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = type(ad)(tuple(perturb(t) for t in ad.tensors),
                                  ad.dims_in, ad.dims_out, ad.pairs)
    tm = build_model(tcfg, device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    tpeft = interop.adapter_set_from_numpy(peft, "cpu")
    return jm, base, peft, tm, tbase, tpeft


def _tokens(b, s, vocab, seed=4):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


ARCHS = ["llama2-7b-proxy", "qwen2-0.5b"]
# the rest of the dense family, on the tests that meet what differs (the
# forward on the kernel backend's wrappers, the port's path)
FAMILY = ["yi-6b", "phi3-medium-14b", "minicpm-2b"]
DENSE = ARCHS + FAMILY


@pytest.mark.parametrize("arch,backend", [
    (a, b) for a in ARCHS for b in ("reference", "pallas")] + [
    (a, "pallas") for a in FAMILY])
def test_forward_matches_jax(arch, backend):
    jm, base, peft, tm, tbase, tpeft = _pair(arch, backend)
    toks = _tokens(2, 40, jm.cfg.vocab_size)
    lj, _ = jm.forward(base, {"tokens": jnp.asarray(toks)}, peft)
    lt, aux = tm.forward(tbase, {"tokens": torch.from_numpy(toks)}, tpeft)
    assert aux == 0.0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    jm, base, peft, tm, tbase, tpeft = _pair(arch, "reference")
    toks = _tokens(3, 24, jm.cfg.vocab_size)
    lens = np.array([24, 7, 13], np.int32)
    lj, cj = jm.prefill(base, peft, {"tokens": jnp.asarray(toks)},
                        lengths=jnp.asarray(lens))
    lt, ct = tm.prefill(tbase, tpeft, {"tokens": torch.from_numpy(toks)},
                        lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]), **TOL)
    assert ct["len"].tolist() == lens.tolist()
    # land the wave in a serving cache, then three decode steps
    jc = jm.insert_cache(jm.init_cache(4, 48), np.array([2, 0, 1]), cj)
    tc = tm.insert_cache(tm.init_cache(4, 48), np.array([2, 0, 1]), ct)
    nxt = _tokens(4, 1, jm.cfg.vocab_size, seed=5)
    for _ in range(3):
        lj, jc = jm.decode_step(base, peft, jc, {"tokens": jnp.asarray(nxt)})
        lt, tc = tm.decode_step(tbase, tpeft, tc,
                                {"tokens": torch.from_numpy(nxt)})
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
        nxt = np.array(jnp.argmax(lj, -1), np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_pallas_backend_matches_jax(arch):
    """The kernel backends (plain versions on the CPU) through decode."""
    jm, base, peft, tm, tbase, tpeft = _pair(arch, "pallas")
    toks = _tokens(2, 16, jm.cfg.vocab_size)
    lens = np.array([16, 9], np.int32)
    _, cj = jm.prefill(base, peft, {"tokens": jnp.asarray(toks)},
                       lengths=jnp.asarray(lens))
    _, ct = tm.prefill(tbase, tpeft, {"tokens": torch.from_numpy(toks)},
                       lengths=torch.from_numpy(lens))
    cj = jm.insert_cache(jm.init_cache(2, 32), np.array([0, 1]), cj)
    ct = tm.insert_cache(tm.init_cache(2, 32), np.array([0, 1]), ct)
    nxt = _tokens(2, 1, jm.cfg.vocab_size, seed=6)
    lj, _ = jm.decode_step(base, peft, cj, {"tokens": jnp.asarray(nxt)})
    lt, _ = tm.decode_step(tbase, tpeft, ct, {"tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_merged_matches_adapted(arch):
    jm, base, peft, tm, tbase, tpeft = _pair(arch, "reference")
    merged = merge_all(tbase, tpeft)
    toks = torch.from_numpy(_tokens(2, 20, jm.cfg.vocab_size))
    la, _ = tm.forward(tbase, {"tokens": toks}, tpeft)
    lm, _ = tm.forward(merged, {"tokens": toks}, None)
    assert float((la - lm).abs().max()) < 1e-3
    # the port's merge equals the JAX package's
    from repro.core.peft import merge_all as j_merge_all

    jmerged = j_merge_all(base, peft)
    np.testing.assert_allclose(
        merged["layers"]["attn"]["q_proj"].numpy(),
        np.asarray(jmerged["layers"]["attn"]["q_proj"]), **TOL)


def test_attach_folds_to_base_at_init():
    """The port's own attach: at step 0 the adapted model is the base."""
    cfg = get_smoke("llama2-7b-proxy")
    from repro_torch.core.peft import PeftConfig, attach

    m = build_model(cfg, device="cpu")
    params = m.init(0)
    base, peft = attach(1, params, PeftConfig(n_axes=4), device="cpu")
    assert peft.paths == ("layers/attn/q_proj", "layers/attn/v_proj")
    assert peft.num_params == 2 * cfg.n_layers * peft["layers"]["attn"][
        "q_proj"].layer(0).num_params
    toks = torch.from_numpy(_tokens(2, 12, cfg.vocab_size))
    l0, _ = m.forward(params, {"tokens": toks})
    l1, _ = m.forward(base, {"tokens": toks}, peft)
    assert float((l0 - l1).abs().max()) < 1e-4


def test_cache_slot_surgery_matches_jax():
    """merge_cache_slots on the dense cache: new stripes where a slot is
    active, old ones elsewhere."""
    from repro.models.common import merge_cache_slots as j_merge
    from repro_torch.models.common import merge_cache_slots

    jm = j_build_model(j_get_smoke("llama2-7b-proxy"))
    tm = build_model(get_smoke("llama2-7b-proxy"), device="cpu")
    rs = np.random.RandomState(7)

    def fill():
        return {k: rs.standard_normal(np.shape(v)).astype(np.float32)
                if k != "len" else rs.randint(1, 16, np.shape(v)).astype(
                    np.int32)
                for k, v in jm.init_cache(3, 16).items()}

    old, new = fill(), fill()
    active = np.array([True, False, True])

    def both(tree):
        return ({k: jnp.asarray(v) for k, v in tree.items()},
                {k: torch.from_numpy(v.copy()) for k, v in tree.items()})

    (jo, to), (jn, tn) = both(old), both(new)
    want = j_merge(jm.cache_spec(), jn, jo, active)
    got = merge_cache_slots(tm.cache_spec(), tn, to, active)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_param_counts_vs_jax():
    """Trainable QuanTA parameters of the attached model and the adapter
    specs equal the JAX package's."""
    jm = j_build_model(j_get_smoke("llama2-7b-proxy"))
    params = jm.init(jax.random.PRNGKey(0))
    _, jpeft = j_attach(jax.random.PRNGKey(1), params,
                        JPeftConfig(method="quanta", n_axes=4))
    tpeft = interop.adapter_set_from_numpy(jpeft, "cpu")
    assert tpeft.num_params == jpeft.num_params
    assert tpeft.paths == tuple(s.path for s in jpeft.specs)


@pytest.mark.parametrize("what", ["fold_free", "family"])
def test_unported_options_raise(what):
    """What the port does not run raises instead of running something
    else: every family builds now, and what stays refused on this path is
    an engine over an ``audio_tokens`` model (musicgen: its decode step
    reads frame embeddings, the engine feeds tokens), which raises at
    construction, where the JAX engine fails at its first step with
    ``KeyError: 'embeds'``.  A fold-free QuanTA bank tenant is not run as
    something else either: it banks as what it is, a delta-form group of
    its factors over the shared base."""
    from repro_torch.core.bank import AdapterBank
    from repro_torch.core.peft import PeftConfig, attach, flatten_paths

    cfg = get_smoke("llama2-7b-proxy")
    if what == "fold_free":
        m = build_model(cfg, device="cpu")
        params = m.init(0)
        bank = AdapterBank.build(params, {"ff": attach(
            1, params, PeftConfig(n_axes=4, fold=False), device="cpu")})
        nodes = flatten_paths(bank.tree).values()
        assert [n.delta_forms for n in nodes] == [(True,), (True,)]
        assert all(n.groups[0].fold_free for n in nodes)
        return
    from repro.serve import Request as JRequest, ServingEngine as JEngine
    from repro_torch.serve import ServingEngine

    audio = dict(family="audio", frontend="audio_tokens")
    m = build_model(cfg.replace(**audio), device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        ServingEngine(m, m.init(0), n_slots=2, max_len=16, device="cpu")
    jm = j_build_model(j_get_smoke("llama2-7b-proxy").replace(**audio))
    eng = JEngine(jm, jm.init(jax.random.PRNGKey(0)), n_slots=2, max_len=16)
    eng.submit(JRequest(uid=0, prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(KeyError, match="embeds"):
        eng.run()
