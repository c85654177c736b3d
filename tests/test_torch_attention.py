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
