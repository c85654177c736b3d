"""The port's training pieces held against the JAX package on the same
numpy inputs (f32, CPU): the chunked cross entropy (loss, d x, d w_head
against ``jax.value_and_grad`` to 1e-5, padded vocab and ignored
labels), kernel 3's ``autograd.Function`` (dq, dk, dv against ``jax.grad``
of the JAX flash attention in Pallas interpret mode to 2e-5: causal,
windowed, GQA, S not a multiple of the block), the SMOKE model's loss (to
1e-5) and its adapter gradients (to 1e-4 of each leaf's largest
magnitude), per-layer remat, and the forward-only guard of the CUDA
wrappers."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.models import build_model as j_build_model
from repro.models import common as jcommon
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.core.adapters import tree_leaves, tree_map
from repro_torch.kernels import KERNELS, launch_counts
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build_model
from repro_torch.models import common as tcommon

jfa = importlib.import_module("repro.kernels.flash_attention")


def _rs(seed):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("s,vocab,vpad,ignore", [
    (16, 200, 256, 0.3),      # 8 chunks, padded vocab, ignored labels
    (13, 256, 256, 0.0),      # S not divisible: one chunk
    (8, 100, 128, 1.0),       # every label ignored: loss 0
    (4, 122753, 122880, 0.2),  # minicpm-2b's vocab, padded by 127
])
def test_fused_cross_entropy_matches_jax(s, vocab, vpad, ignore):
    rs = _rs(0)
    x = rs.standard_normal((3, s, 32)).astype(np.float32)
    w = (0.2 * rs.standard_normal((32, vpad))).astype(np.float32)
    labels = rs.randint(0, vocab, (3, s)).astype(np.int32)
    labels[rs.random_sample((3, s)) < ignore] = -100
    jl, (jdx, jdw) = jax.value_and_grad(
        lambda a, b: jcommon.fused_cross_entropy(a, b, jnp.asarray(labels),
                                                 vocab), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = tcommon.fused_cross_entropy(tx, tw, torch.from_numpy(labels), vocab)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-7)
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-6))
    # without grad: the same loss, no checkpoint
    with torch.no_grad():
        assert float(tcommon.fused_cross_entropy(
            tx, tw, torch.from_numpy(labels), vocab)) == float(tl.detach())


FLASH = [
    # (s, h, kvh, hd, window, block_q)
    (40, 4, 4, 16, None, 16),     # causal, S not a multiple of the block
    (40, 4, 4, 16, 7, 16),        # windowed
    (48, 4, 2, 16, None, 16),     # GQA
    (33, 8, 2, 8, 12, 64),        # GQA + window, S < block
]


def _qkvg(s, h, kvh, hd, seed=0):
    rs = _rs(seed)
    return tuple(rs.standard_normal(shape).astype(np.float32) for shape in
                 ((2, s, h, hd), (2, s, kvh, hd), (2, s, kvh, hd),
                  (2, s, h, hd)))


@pytest.mark.parametrize("s,h,kvh,hd,window,bq", FLASH)
def test_flash_function_grads_match_jax(s, h, kvh, hd, window, bq):
    q, k, v, g = _qkvg(s, h, kvh, hd)
    @jax.jit
    def jax_vjp(a, b, c, ct):
        return jax.vjp(lambda a, b, c: jfa.flash_attention(
            a, b, c, window=window, block_q=bq, block_k=bq), a, b, c)[1](ct)

    want = jax_vjp(*(jnp.asarray(t) for t in (q, k, v, g)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, window=window, block_q=bq)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)
    # the forward is the kernel's (its plain version here), unchanged
    with torch.no_grad():
        plain = tfa.flash_attention(tq, tk, tv, window=window)
    assert plain.grad_fn is None and torch.equal(out.detach(), plain)
    # the backward is autograd of the banded recompute, bit for bit
    sq, sk, sv = (t.detach().requires_grad_(True) for t in (tq, tk, tv))
    rec = tfa.banded_recompute(sq, sk, sv, block_q=bq, window=window,
                               scale=1.0 / np.sqrt(hd))
    ref = torch.autograd.grad(rec, (sq, sk, sv), torch.from_numpy(g))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # and the banded recompute is the reference attention
    torch.testing.assert_close(rec, tfa.blockwise_reference_attention(
        sq, sk, sv, q_block=bq, window=window), rtol=1e-6, atol=1e-6)


def _pair(backend, n_axes=4):
    jcfg = j_get_smoke("llama2-7b-proxy").replace(attn_backend=backend)
    tcfg = get_smoke("llama2-7b-proxy").replace(attn_backend=backend)
    jm = j_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    base, peft = j_attach(jax.random.PRNGKey(1), params,
                          JPeftConfig(method="quanta", n_axes=n_axes))
    tm = build_model(tcfg, device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    return jm, base, peft, tm, tbase, interop.adapter_set_from_numpy(
        peft, "cpu")


def _batch(s=32, seed=3):
    rs = _rs(seed)
    toks = rs.randint(0, 256, (4, s)).astype(np.int32)
    labels = rs.randint(0, 256, (4, s)).astype(np.int32)
    labels[:, : s // 2] = -100
    return {"tokens": toks, "labels": labels}


def _fresh(peft):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(peft)]
    it = iter(leaves)
    return tree_map(lambda _: next(it), peft), leaves


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_loss_and_adapter_grads_match_jax(backend):
    jm, base, peft, tm, tbase, tpeft = _pair(backend)
    batch = _batch()
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(base, p, b)))(
        peft, {k: jnp.asarray(v) for k, v in batch.items()})
    tree, leaves = _fresh(tpeft)
    tl = tm.loss(tbase, tree, batch)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = tree_leaves(interop.adapter_set_from_numpy(jg, "cpu"))
    assert len(want) == len(grads) > 0
    for got, w in zip(grads, want):
        scale = float(w.abs().max())
        assert scale > 0
        assert float((got - w).abs().max()) <= 1e-4 * scale
    # the base weights took no gradient and were never asked for one
    assert not any(t.requires_grad for t in tree_leaves(tbase))


def test_remat_changes_nothing_but_memory():
    _, _, _, tm, tbase, tpeft = _pair("pallas")
    batch = _batch(s=24)
    out = []
    for remat in (True, False):
        m = build_model(tm.cfg.replace(remat=remat), device="cpu")
        tree, leaves = _fresh(tpeft)
        loss = m.loss(tbase, tree, batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


class _Launched(Exception):
    """Raised in place of loading a kernel library: the wrapper got past
    its route to the launch."""


def _guard_cases():
    from repro_torch.core.quanta import QuantaAdapter
    from repro_torch.core.quantize import quantize_kv, quantize_linear
    from repro_torch.kernels.banked_gather import (
        banked_lora_delta, banked_lora_linear,
    )
    from repro_torch.kernels.quanta_apply import quanta_apply
    from repro_torch.kernels.quanta_linear import quanta_linear
    from repro_torch.kernels.quantized_matmul import quantized_matmul

    gen = torch.Generator().manual_seed(0)
    ad = QuantaAdapter.create(gen, 64, n_axes=3)
    t = [x.clone().requires_grad_(True) for x in ad.tensors]
    rnd = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    x = rnd(3, 64).requires_grad_(True)
    w = rnd(64, 64)
    q = rnd(2, 1, 4, 16).requires_grad_(True)
    cache = rnd(2, 8, 4, 16)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    pool = rnd(5, 4, 4, 16)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    codes, scales = quantize_kv(pool, "int8", block_size=16)
    a = rnd(3, 64, 4).requires_grad_(True)
    b = rnd(3, 4, 32)
    ids = torch.tensor([2, 0], dtype=torch.int32)
    xb = rnd(2, 3, 64)
    return {
        "quanta_apply": lambda: quanta_apply(x, t, ad.dims_in, ad.pairs),
        "quanta_linear": lambda: quanta_linear(x.detach(), w, t, ad.dims_in,
                                               ad.pairs),
        "flash_decode_attention": lambda: tfa.flash_decode_attention(
            q, cache, cache, lens),
        "paged_flash_decode_attention":
            lambda: tfa.paged_flash_decode_attention(q, pool, pool, tables,
                                                     lens),
        "paged_flash_decode_attention_quant":
            lambda: tfa.paged_flash_decode_attention_quant(
                q, codes, scales, codes, scales, tables, lens,
                kv_quant="int8", quant_block=16),
        "quantized_matmul": lambda: quantized_matmul(
            x, quantize_linear(w, "int8", block_size=16)),
        "banked_lora_linear": lambda: banked_lora_linear(
            xb, w[:, :32], a, b, ids, scale=1.0),
        "banked_lora_delta": lambda: banked_lora_delta(xb, a, b, ids,
                                                       scale=1.0),
    }


@pytest.mark.parametrize("name", sorted(set(KERNELS) - {"flash_attention"}))
def test_forward_only_kernels_refuse_autograd(name, monkeypatch):
    """On the CUDA route, a wrapper whose operand requires grad raises
    under grad mode, before any launch, instead of handing back an output
    with no gradient; under no_grad it goes on to launch."""
    from repro_torch.kernels import _build

    def no_load(name):
        raise _Launched(name)

    monkeypatch.setattr(dispatch, "device_route", lambda *t: "cuda")
    monkeypatch.setattr(_build, "load", no_load)
    call = _guard_cases()[name]
    before = launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert launch_counts() == before
    with torch.no_grad(), pytest.raises(Exception) as info:
        call()
    assert "no backward" not in str(info.value)


def test_flash_attention_is_exempt_from_the_guard(monkeypatch):
    """Kernel 3 launches inside its autograd.Function (grad mode off
    there), so the guard lets it through to the launch."""
    from repro_torch.kernels import _build

    def no_load(name):
        raise _Launched(name)

    monkeypatch.setattr(dispatch, "device_route", lambda *t: "cuda")
    monkeypatch.setattr(_build, "load", no_load)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(_Launched, match="flash_attention"):
        tfa.flash_attention(q, q, q)


def test_guard_leaves_the_plain_route_differentiable():
    """CPU tensors take the plain versions, which differentiate."""
    cases = _guard_cases()
    out = cases["quanta_apply"]()
    assert out.grad_fn is not None
    out.sum().backward()
