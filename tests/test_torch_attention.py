"""The port's flash forward and flash decode (their plain versions on the
CPU) held against the JAX kernels in Pallas interpret mode, on the same
numpy-seeded inputs: GQA, windows, odd S and mixed cache lengths, f32 at
3e-5 as tests/test_attention.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.dispatch import MASK_VALUE
from repro_torch.kernels.smem import DEC_SLICE, decode_plan
from repro_torch.models import attention as tattn

# the module (the JAX package re-exports its function under the module's
# own name)
jfa = importlib.import_module("repro.kernels.flash_attention")

TOL = dict(rtol=3e-5, atol=3e-5)


def _qkv(s, h, kvh, hd, b=2, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))


SWEEP = [
    # (s, h, kvh, hd, window, q_block, kv_block)
    (64, 4, 2, 16, None, 32, 32),
    (64, 4, 4, 8, 24, 16, 16),       # MHA + window
    (97, 4, 2, 16, None, 32, 32),    # prime S
    (50, 6, 3, 16, 16, 32, 16),      # uneven S, rectangular blocks
    (33, 8, 1, 8, None, 64, 64),     # MQA, S < block
    (64, 4, 2, 16, 1, 32, 32),       # degenerate window: self-only
]


@pytest.mark.parametrize("s,h,kvh,hd,window,bq,bk", SWEEP)
def test_flash_forward_matches_jax_kernel(s, h, kvh, hd, window, bq, bk):
    q, k, v = _qkv(s, h, kvh, hd)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=bq, block_k=bk))
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # and the reference backend of both packages
    ref_j = np.asarray(jattn.blockwise_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_block=bq,
        window=window))
    ref_t = tattn.blockwise_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_block=bq, window=window).numpy()
    np.testing.assert_allclose(ref_t, ref_j, **TOL)


DECODE = [
    # (s_max, h, kvh, hd, window, lens)
    (64, 4, 2, 16, None, [1, 17, 64]),
    (96, 4, 4, 8, 20, [96, 5, 40]),
    (37, 8, 1, 16, None, [37, 36, 2]),     # odd S_max, MQA
    (64, 6, 3, 16, 8, [9, 63, 1]),
    # longer caches: extents of several 64-key tiles and one no tile
    # divides, windows across tile edges, a window of 1, lengths 1, 64, 65
    # and the full extent, G 1, 7 and 8
    (200, 4, 4, 16, None, [1, 64, 65, 200]),
    (200, 7, 1, 16, 70, [200, 65, 64, 1]),
    (300, 8, 1, 8, 1, [300, 1, 129, 64]),
    (300, 2, 2, 16, 100, [300, 257, 65, 1]),
    (1100, 2, 2, 8, None, [1100, 1, 1000]),
    (1100, 8, 1, 8, 130, [1100, 129, 65]),
]


@pytest.mark.parametrize("s_max,h,kvh,hd,window,lens", DECODE)
def test_flash_decode_matches_jax_kernel(s_max, h, kvh, hd, window, lens):
    b = len(lens)
    rs = np.random.RandomState(3)
    q = rs.standard_normal((b, 1, h, hd)).astype(np.float32)
    kc = rs.standard_normal((b, s_max, kvh, hd)).astype(np.float32)
    vc = rs.standard_normal((b, s_max, kvh, hd)).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    want = np.asarray(jfa.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ln),
        window=window, block_k=32))
    got = tfa.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(ln), window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ref_j = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ln),
        window=window))
    ref_t = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(ln), window=window).numpy()
    np.testing.assert_allclose(ref_t, ref_j, **TOL)


def _two_pass_decode(q, k, v, lens, window):
    """The bf16 split decode's two passes in plain PyTorch: the score pass
    takes the extent in ``decode_plan``'s chunks and keeps every key's fp32
    score; the value pass takes head_dim in ``DEC_SLICE``-dim slices, each
    walking its slot's 64-key tiles over those scores with attend_block's
    online softmax and PV on its slice alone."""
    b, _, h, hd = q.shape
    s_max, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / hd ** 0.5
    plan = decode_plan(s_max, hd, g)
    qg = q.reshape(b, 1, kvh, g, hd).float()
    scores = torch.empty((b, kvh, g, 1, s_max))
    for c in range(plan.splits):
        lo, hi = c * plan.chunk, min((c + 1) * plan.chunk, s_max)
        scores[..., lo:hi] = torch.einsum(
            "brkgh,bskh->bkgrs", qg, k[:, lo:hi].float()) * scale
    pos = torch.arange(s_max)
    q_pos = lens.long() - 1
    ok = pos[None] <= q_pos[:, None]
    j_lo = torch.zeros_like(q_pos)
    if window is not None:
        ok &= (q_pos[:, None] - pos[None]) < window
        j_lo = torch.clamp(q_pos - window + 1, min=0) // 64
    scores = torch.where(ok[:, None, None, None], scores, MASK_VALUE)
    out = torch.empty((b, kvh, g, 1, hd), dtype=v.dtype)
    for d0 in range(0, hd, DEC_SLICE):
        d1 = min(d0 + DEC_SLICE, hd)
        m = torch.full((b, kvh, g, 1), MASK_VALUE)
        denom = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, 1, d1 - d0))
        for j in range(-(-s_max // 64)):
            sc = scores[..., j * 64:(j + 1) * 64]
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            pv = torch.einsum("bkgrs,bskh->bkgrh", p.to(v.dtype).float(),
                              v[:, j * 64:(j + 1) * 64, :, d0:d1].float())
            visit = ((j_lo <= j) & (j <= q_pos // 64))[:, None, None, None]
            denom = torch.where(visit, alpha * denom + p.sum(dim=-1), denom)
            acc = torch.where(visit[..., None], acc * alpha[..., None] + pv,
                              acc)
            m = torch.where(visit, m_new, m)
        out[..., d0:d1] = (acc / torch.where(denom == 0, 1.0, denom)[
            ..., None]).to(v.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)


@pytest.mark.parametrize("s_max,h,kvh,hd,window,lens", [
    (512, 4, 4, 128, None, [33, 100, 385, 512, 1, 64, 65, 200]),
    (512, 8, 1, 64, 50, [512, 65, 1, 300]),       # G 8, window
    (1100, 7, 1, 100, 130, [1100, 129, 65, 1]),   # chunks of two tiles
    (200, 16, 2, 72, 1, [200, 64, 65, 1]),        # window of 1
    (300, 2, 2, 128, 100, [300, 257, 65, 0]),     # a slot of length 0
    (130, 64, 1, 12, None, [130, 64]),            # G 64, hd off 16 bytes
])
def test_two_pass_split_decode_keeps_the_plain_walks_bits(s_max, h, kvh, hd,
                                                          window, lens):
    """The bf16 split decode's arithmetic (scores by chunks of keys, then
    PV by slices of head_dim walking the slot's tiles) gives the plain
    one-block walk's output bit for bit, which is why kernels 4 and 5 are
    held to the unchanged plain versions."""
    gen = torch.Generator().manual_seed(s_max + h + hd)
    q, k, v = (torch.randn(shape, generator=gen).bfloat16() for shape in
               ((len(lens), 1, h, hd), (len(lens), s_max, kvh, hd),
                (len(lens), s_max, kvh, hd)))
    ln = torch.tensor(lens, dtype=torch.int32)
    want = tfa.flash_decode_attention_plain(q, k, v, ln, window=window)
    assert torch.equal(_two_pass_decode(q, k, v, ln, window), want)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,h,kvh,window", [
    (130, 4, 2, None), (200, 4, 4, 70), (64, 2, 1, 1),
])
def test_kernel_plain_versions_match_reference(s, h, kvh, window, dtype,
                                               tol):
    """The kernels' plain versions (online softmax over 64-key tiles, ``p``
    cast before it is normalised) and the reference backend (softmax
    normalised, then cast) compute one function."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(s, h, kvh, 16))
    close = dict(rtol=tol, atol=tol)
    torch.testing.assert_close(
        tfa.flash_attention_plain(q, k, v, window=window).float(),
        tfa.blockwise_reference_attention(q, k, v, window=window).float(),
        **close)
    lens = torch.tensor([s, s // 3], dtype=torch.int32)
    torch.testing.assert_close(
        tfa.flash_decode_attention_plain(q[:, :1], k, v, lens,
                                         window=window).float(),
        tfa.decode_reference_attention(q[:, :1], k, v, lens,
                                       window=window).float(), **close)


@pytest.mark.parametrize("s,bq,bk,window", [
    (64, 32, 32, None), (97, 32, 16, 24), (33, 64, 64, None),
    (512, 64, 64, 100), (384, 64, 64, None),
])
def test_block_accounting_matches_jax(s, bq, bk, window):
    assert tfa.pad_to_q_block(s, bq) == jfa.pad_to_q_block(s, bq)
    n_k = -(-s // bk)
    for q_lo in range(0, s, bq):
        assert tfa._visible_j_range(q_lo, bq, bk, n_k, window) == \
            jfa._visible_j_range(q_lo, bq, bk, n_k, window)


def test_cpu_wrappers_launch_nothing():
    q, k, v = _qkv(40, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = (tfa.flash_attention.launches,
              tfa.flash_decode_attention.launches)
    tfa.flash_attention(tq, tk, tv)
    tfa.flash_decode_attention(tq[:, :1], tk, tv,
                               torch.tensor([40, 3], dtype=torch.int32))
    assert (tfa.flash_attention.launches,
            tfa.flash_decode_attention.launches) == before



def test_kernel_backend_refuses_reference_only_knobs():
    """``fast_softmax`` belongs to the reference path; the kernel backend
    refuses it rather than ignore it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 4, 2, 8))
    with pytest.raises(ValueError, match="fast_softmax"):
        tattn.blockwise_causal_attention(q, k, v, fast_softmax=True,
                                         backend="pallas")
    with pytest.raises(ValueError, match="fast_softmax"):
        tattn.decode_attention(q[:, :1], k, v,
                               torch.tensor([16, 3], dtype=torch.int32),
                               fast_softmax=True, backend="pallas")
