"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (rectangular and odd-axis chains, row counts
that no tile divides, GQA, windows, mixed cache lengths).

Every test here needs the card and skips without one.  The file imports
neither ``jax`` nor the JAX package, so on a machine with the card and no
JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.factorize import pair_schedule
from repro_torch.core.quanta import QuantaAdapter, apply_sequential
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import launch_counts
from repro_torch.kernels.quanta_apply import quanta_apply
from repro_torch.kernels.quanta_linear import (
    quanta_linear, quanta_linear_plain,
)

pytestmark = pytest.mark.cuda

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def dev():
    """The card; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, dtype):
    tol = F32 if dtype == torch.float32 else BF16
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


CHAINS = [
    # (d_in, d_out, dims_in, rows)
    (64, 64, (4, 4, 4), 1),
    (24, 12, (4, 3, 2), 37),          # rectangular, odd axes
    (128, 256, (8, 4, 4), 301),       # rectangular, widening
    (896, 896, (16, 8, 7), 19),       # qwen2-0.5b's 16-8-7 scheme
    (4096, 4096, (16, 8, 8, 4), 9),   # llama2-7b's scheme, ragged tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out,dims,rows", CHAINS)
def test_chain_kernels_match_plain(d_in, d_out, dims, rows, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(rows)
    ad = QuantaAdapter.create(gen, d_in, d_out, dims_in=dims, init="normal",
                              dtype=dtype, device=dev)
    x = torch.randn((rows, d_in), generator=gen, device=dev).to(dtype)
    w = (0.05 * torch.randn((d_in, d_out), generator=gen, device=dev)
         ).to(dtype)
    before = launch_counts()
    got = quanta_apply(x, ad.tensors, ad.dims_in, ad.pairs)
    torch.cuda.synchronize()
    _close(got, apply_sequential(x, ad.tensors, ad.dims_in, ad.pairs),
           dtype)
    if d_out % 8 == 0 or dtype == torch.float32:
        got = quanta_linear(x, w, ad.tensors, ad.dims_in, ad.pairs)
        torch.cuda.synchronize()
        _close(got, quanta_linear_plain(x, w, ad.tensors, ad.dims_in,
                                        ad.pairs), dtype)
    after = launch_counts()
    assert after["quanta_apply"] > before["quanta_apply"]


def test_chain_two_rounds_and_empty_rows(dev):
    """Two rounds of the pair schedule (12 stages), and zero rows."""
    gen = torch.Generator(device=dev).manual_seed(0)
    dims = (4, 4, 2, 2)
    ad = QuantaAdapter.create(gen, 64, dims_in=dims,
                              pairs=pair_schedule(4) * 2, device=dev)
    x = torch.randn((33, 64), generator=gen, device=dev)
    _close(quanta_apply(x, ad.tensors, dims, ad.pairs),
           apply_sequential(x, ad.tensors, dims, ad.pairs), torch.float32)
    assert quanta_apply(x[:0], ad.tensors, dims, ad.pairs).shape == (0, 64)


ATTN = [
    # (b, s, h, kv, hd, window)
    (2, 97, 8, 2, 64, None),     # GQA, S no tile divides
    (2, 97, 8, 2, 64, 30),
    (1, 384, 32, 32, 128, None),  # llama2-7b's heads
    (3, 64, 4, 1, 16, 1),        # MQA, self-only window
    (1, 5, 14, 2, 64, None),     # qwen2-0.5b's heads, S < one tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,window", ATTN)
def test_flash_kernels_match_plain(b, s, h, kv, hd, window, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
    got = FA.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    _close(got, FA.flash_attention_plain(q, k, v, window=window), dtype)
    lens = torch.tensor([s - 3 * i for i in range(b)], dtype=torch.int32,
                        device=dev).clamp_min(1)
    got = FA.flash_decode_attention(q[:, :1], k, v, lens, window=window)
    torch.cuda.synchronize()
    _close(got, FA.flash_decode_attention_plain(q[:, :1], k, v, lens,
                                                window=window), dtype)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 8, 2, 256), device=dev)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)          # head_dim above 128
    q, k = torch.zeros((1, 8, 2, 64), device=dev), torch.zeros(
        (1, 7, 2, 64), device=dev)
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, k)          # k shorter than q
    with pytest.raises(ValueError):          # one length for two slots
        FA.flash_decode_attention(torch.zeros((2, 1, 2, 64), device=dev),
                                  k.expand(2, -1, -1, -1),
                                  k.expand(2, -1, -1, -1),
                                  torch.ones((1,), dtype=torch.int32,
                                             device=dev))
    x = torch.zeros((4, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        quanta_apply(x, [torch.zeros((4, 4, 4, 4), device=dev)], (4, 4, 4),
                     [(1, 2)])               # tensors not in x's dtype
