"""The port's frontend models (musicgen-large's audio and pixtral-12b's
vision stubs, SMOKE: 2 layers, d_model 64) held against the JAX package
on the same numpy-seeded inputs in float32: ``forward``, ``loss`` (and its
QuanTA gradients) and ``prefill`` with and without ``lengths`` at 1e-4,
musicgen's teacher-forced ``decode_step`` over frame embeddings at 2e-4
(the JAX package's own check against the full forward), pixtral's
prefill of patches and text then greedy decode (tokens equal), its
chunked prefill of text, ``input_specs`` and ``cache_slot_spec``, the
init's leaves (no table for audio), and every config of ``ARCH_IDS``
equal to the JAX registry's.  Weights and perturbed QuanTA come from the
JAX package through ``interop``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro.models import cache_slot_spec as j_cache_slot_spec
from repro.models import input_specs as j_input_specs
from repro.models.common import ShapeConfig as JShapeConfig
from repro_torch import configs, interop
from repro_torch.core.adapters import tree_leaves, tree_map
from repro_torch.core.peft import flatten_paths
from repro_torch.models import (
    ShapeConfig, Transformer, build_model, cache_slot_spec, input_specs,
)

ARCHS = ("musicgen-large", "pixtral-12b")
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          jnp.int32: torch.int32}
BY_NAME = {str(jnp.dtype(k)): v for k, v in DTYPES.items()}
TOL = dict(rtol=1e-4, atol=1e-4)
VOCAB = 256


@functools.lru_cache(maxsize=None)
def _jax_weights(arch):
    jm = j_build_model(jconfigs.get_smoke(arch))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    peft_cfg = configs.get_peft(arch)
    base, peft = jax.jit(lambda p: j_attach(
        jax.random.PRNGKey(1), p, JPeftConfig(
            method="quanta", n_axes=peft_cfg.n_axes,
            targets=peft_cfg.targets)))(params)
    rs = np.random.RandomState(3)
    peft = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), peft)
    return params, base, peft


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax model, jax base, jax peft, port model, port base, port peft),
    the port on the kernel backends' wrappers (their plain versions on the
    CPU)."""
    _, base, peft = _jax_weights(arch)
    jm = j_build_model(jconfigs.get_smoke(arch))
    tm = build_model(configs.get_smoke(arch).replace(
        attn_backend="pallas", peft_backend="pallas"), device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    return jm, base, peft, tm, tbase, interop.adapter_set_from_numpy(
        peft, "cpu")


def _batch(arch, b, s, seed=4, labels=False):
    """A numpy batch of ``s`` positions: frame embeddings (audio), or
    ``n_patches`` patch embeddings before ``s - n_patches`` tokens
    (vision); labels over all ``s`` positions."""
    cfg = configs.get_smoke(arch)
    rs = np.random.RandomState(seed)
    if cfg.frontend == "audio_tokens":
        batch = {"embeds": rs.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)}
    else:
        p = cfg.n_patches
        batch = {"patch_embeds": rs.standard_normal(
            (b, p, cfg.d_model)).astype(np.float32),
            "tokens": rs.randint(0, VOCAB, (b, s - p)).astype(np.int32)}
    if labels:
        batch["labels"] = rs.randint(0, VOCAB, (b, s)).astype(np.int32)
        batch["labels"][0, :3] = -100
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """Full-sequence logits over 40 positions (pixtral: 16 patches then 24
    tokens) at 1e-4."""
    jm, base, peft, tm, tbase, tpeft = _pair(arch)
    batch = _batch(arch, 2, 40)
    lj, _ = jax.jit(jm.forward)(base, _jnp(batch), peft)
    lt, aux = tm.forward(tbase, batch, tpeft)
    assert tuple(lt.shape) == (2, 40, VOCAB) and aux == 0.0
    _close(lt, lj)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """The loss (labels over every position, pixtral's patches among
    them, some ignored) at 1e-5 and its gradient on every QuanTA tensor at
    1e-4 of the largest; the base takes no gradient."""
    jm, base, peft, _, tbase, tpeft = _pair(arch)
    tm = build_model(configs.get_smoke(arch), device="cpu")
    batch = _batch(arch, 2, 32, seed=6, labels=True)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(base, p, _jnp(batch))))(peft)
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


@pytest.mark.parametrize("lengths", [None, (40, 23)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, lengths):
    """Prefill of a (right-padded) wave: the logits of each row's last
    real position and the KV cache at 1e-4, ``len`` exact (lengths count
    pixtral's patches)."""
    jm, base, peft, tm, tbase, tpeft = _pair(arch)
    batch = _batch(arch, 2, 40, seed=8)
    lens = None if lengths is None else np.array(lengths, np.int32)
    lj, cj = jax.jit(jm.prefill)(base, peft, _jnp(batch),
                                 None if lens is None else jnp.asarray(lens))
    lt, ct = tm.prefill(tbase, tpeft, batch, lengths=lens)
    _close(lt, lj)
    for k in ("k", "v"):
        _close(ct[k], cj[k])
    np.testing.assert_array_equal(ct["len"].numpy(), np.asarray(cj["len"]))


def test_musicgen_teacher_forced_decode_matches_jax():
    """24 decode steps over frame embeddings ``(B, 1, d)`` from an empty
    cache: each step's logits equal the JAX decode step's and the port's
    own full forward's at 2e-4 (the JAX package's decode-vs-forward
    check)."""
    arch = "musicgen-large"
    jm, base, peft, tm, tbase, tpeft = _pair(arch)
    s = 24
    frames = _batch(arch, 2, s, seed=10)["embeds"]
    full, _ = tm.forward(tbase, {"embeds": frames}, tpeft)
    jdec = jax.jit(lambda c, e: jm.decode_step(base, peft, c,
                                               {"embeds": e}))
    jc, tc = jm.init_cache(2, s), tm.init_cache(2, s)
    for t in range(s):
        step = frames[:, t:t + 1]
        lj, jc = jdec(jc, jnp.asarray(step))
        lt, tc = tm.decode_step(tbase, tpeft, tc, {"embeds": step})
        _close(lt, lj, rtol=2e-4, atol=2e-4)
        _close(lt[:, 0], full[:, t], rtol=2e-4, atol=2e-4)
    assert tc["len"].tolist() == [s, s]


def test_pixtral_prefill_then_decode_tokens_match_jax():
    """Patches and text prefilled into a wave (rows of 40 and 29
    positions), inserted into a cache of 64 rows, then 12 greedy decode
    steps of text: the port's tokens equal the JAX model's."""
    arch = "pixtral-12b"
    jm, base, peft, tm, tbase, tpeft = _pair(arch)
    batch = _batch(arch, 2, 40, seed=12)
    lens = np.array([40, 29], np.int32)
    lj, cj = jax.jit(jm.prefill)(base, peft, _jnp(batch), jnp.asarray(lens))
    lt, ct = tm.prefill(tbase, tpeft, batch, lengths=lens)
    slots = np.array([1, 0])
    jcache = jm.insert_cache(jm.init_cache(2, 64), jnp.asarray(slots), cj,
                             jnp.asarray(lens))
    tcache = tm.insert_cache(tm.init_cache(2, 64), torch.from_numpy(slots),
                             ct, torch.from_numpy(lens))
    jdec = jax.jit(lambda c, t: jm.decode_step(base, peft, c,
                                               {"tokens": t}))
    jt = np.asarray(lj[:, 0, :VOCAB].argmax(-1))[slots.argsort()][:, None]
    tt = lt[:, 0, :VOCAB].argmax(-1)[torch.from_numpy(slots.argsort())][
        :, None]
    got, want = [tt[:, 0].tolist()], [jt[:, 0].tolist()]
    for _ in range(12):
        lj, jcache = jdec(jcache, jnp.asarray(jt, jnp.int32))
        lt, tcache = tm.decode_step(tbase, tpeft, tcache, {"tokens": tt})
        jt = np.asarray(lj[:, 0, :VOCAB].argmax(-1))[:, None]
        tt = lt[:, 0, :VOCAB].argmax(-1)[:, None]
        got.append(tt[:, 0].tolist())
        want.append(jt[:, 0].tolist())
    assert got == want
    assert tcache["len"].tolist() == [29 + 12, 40 + 12]


def test_prefill_chunk_takes_text_and_refuses_audio():
    """pixtral's chunk step embeds text tokens alone, as the JAX package's
    (1e-4 against it on one chunk of 8 after 5 staged positions); an audio
    model has no token table and raises."""
    arch = "pixtral-12b"
    jm, base, peft, tm, tbase, tpeft = _pair(arch)
    toks = np.random.RandomState(14).randint(0, VOCAB, (1, 8)).astype(
        np.int32)
    lj, cj = jax.jit(jm.prefill_chunk)(base, peft, {"tokens": jnp.asarray(
        toks)}, jm.init_cache(1, 32), 5, 6)
    lt, ct = tm.prefill_chunk(tbase, tpeft, {"tokens": toks},
                              tm.init_cache(1, 32), 5, 6)
    _close(lt, lj)
    _close(ct["k"], cj["k"])
    assert ct["len"].tolist() == [11]
    audio = build_model(configs.get_smoke("musicgen-large"), device="cpu")
    with pytest.raises(ValueError, match="no token table"):
        audio.prefill_chunk(audio.init(0), None, {"tokens": toks},
                            audio.init_cache(1, 32), 0, 8)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, kind):
    """``input_specs`` of the FULL config: the JAX package's keys, shapes
    and dtypes, on the ``meta`` device; a vision model raises where the
    sequence does not exceed its patches."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    seq = 2048 if kind != "decode" else 4096
    got = input_specs(cfg, ShapeConfig("cell", seq, 8, kind))
    want = j_input_specs(jcfg, JShapeConfig("cell", seq, 8, kind))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype is BY_NAME[str(w.dtype)], k
        assert got[k].device.type == "meta"
    if cfg.frontend == "vision_embeds" and kind != "decode":
        short = ShapeConfig("cell", cfg.n_patches, 8, kind)
        with pytest.raises(ValueError, match="must exceed n_patches"):
            input_specs(cfg, short)
        with pytest.raises(ValueError, match="must exceed n_patches"):
            j_input_specs(jcfg, JShapeConfig("cell", cfg.n_patches, 8, kind))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_layout_matches_jax(arch):
    """``build_model`` gives the Transformer; its init has the JAX
    package's leaves, shapes and dtypes (no embedding table for audio),
    and ``cache_slot_spec`` the JAX layout."""
    cfg = configs.get_smoke(arch)
    tm = build_model(cfg, device="cpu")
    assert isinstance(tm, Transformer)
    tflat = flatten_paths(tm.init(0))
    jflat = flatten_paths(jax.tree_util.tree_map(
        np.asarray, _jax_weights(arch)[0]))
    assert sorted(tflat) == sorted(jflat)
    assert ("embed/tokens" in tflat) == (cfg.frontend == "vision_embeds")
    for path, w in jflat.items():
        assert tuple(tflat[path].shape) == w.shape, path
        assert tflat[path].dtype == torch.float32
    got = cache_slot_spec(configs.get_config(arch))
    want = j_cache_slot_spec(jconfigs.get_config(arch))
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
        k: dataclasses.asdict(v) for k, v in want.items()}


def _same(t_value, j_value):
    if j_value in DTYPES:
        return t_value is DTYPES[j_value]
    return t_value == j_value


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_arch_configs_equal_jax(arch):
    """Every arch of ``ARCH_IDS`` (the JAX registry's, in its order): the
    FULL and SMOKE model configs field for field (the frontend fields
    among them), the PEFT config and the notes."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for which in ("get_config", "get_smoke"):
        got, want = (getattr(configs, which)(arch),
                     getattr(jconfigs, which)(arch))
        for f in dataclasses.fields(got):
            assert _same(getattr(got, f.name), getattr(want, f.name)), (
                which, f.name)
    got, want = configs.get_peft(arch), jconfigs.get_peft(arch)
    for f in dataclasses.fields(got):
        assert _same(getattr(got, f.name), getattr(want, f.name)), f.name
    assert configs.get_notes(arch) == jconfigs.get_notes(arch) != ""
