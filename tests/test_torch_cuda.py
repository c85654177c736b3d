"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (rectangular and odd-axis chains, row counts
that no tile divides, GQA, windows, mixed cache lengths, paged pools with
shuffled tables and repeated tails, NF4 and int8 weights and KV codes,
banked LoRA over repeated and neutral ids with ragged columns).

Every test here needs the card and skips without one.  The file imports
neither ``jax`` nor the JAX package, so on a machine with the card and no
JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.factorize import pair_schedule
from repro_torch.core.quanta import QuantaAdapter, apply_sequential
from repro_torch.core.quantize import (
    QuantizedLinear, matmul_ref, quantize_kv, quantize_linear,
)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import launch_counts
from repro_torch.kernels.banked_gather import (
    banked_lora_delta, banked_lora_linear,
)
from repro_torch.kernels.quanta_apply import quanta_apply
from repro_torch.kernels.quanta_linear import (
    quanta_linear, quanta_linear_plain,
)
from repro_torch.kernels.quantized_matmul import quantized_matmul
from repro_torch.kernels.ref import (
    banked_lora_delta_ref, banked_lora_linear_ref,
)

pytestmark = pytest.mark.cuda

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def _kernels_built():
    """Every kernel built before the first test runs on the card: with
    ``nvcc`` started from the test process after the card is in use, the
    profiler sessions of the route tests lost their kernel records (the
    route tests then fail though the kernels launched)."""
    if torch.cuda.is_available():
        from repro_torch.kernels import _build

        _build.build_all()


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
    # the rest of the dense family's q_proj / v_proj chains: yi-6b's
    # 16-16-16 (its tensors streamed) and GQA 4096 -> 512 (a k of 512),
    # phi3-medium-14b's 16-8-8-5 and 5120 -> 1280 (a k of 20),
    # minicpm-2b's 16-12-12 (4.3 KB under the bf16 limit)
    (4096, 4096, (16, 16, 16), 9),
    (4096, 512, (64, 8, 8), 9),
    (5120, 5120, (16, 8, 8, 5), 9),
    (5120, 1280, (32, 8, 5, 4), 9),
    (2304, 2304, (16, 12, 12), 9),
    # mamba2-1.3b's widening x_proj / z_proj chain (its 512 x 512 last
    # stage tensor streamed in chunks of its rows) and its out_proj chain
    (2048, 4096, (16, 16, 8), 9),
    (4096, 2048, (32, 16, 8), 9),
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


# kernel 2's bf16 bodies: (d_in, d_out, dims_in) x rows on both sides of
# the 64-row edge (8: the tick's wgmma N of 8; 9-64: N of 64; 65 and up:
# the wgmma tile body), and d_out other than d_in
LINEAR_SHAPES = [(4096, 4096, (16, 8, 8, 4)), (512, 1024, (8, 8, 8)),
                 (1024, 512, (8, 8, 4, 4))]
LINEAR_ROWS = [1, 8, 9, 64, 65, 1001, 3072]


@pytest.mark.parametrize("rows", LINEAR_ROWS)
@pytest.mark.parametrize("d_in,d_out,dims", LINEAR_SHAPES)
def test_linear_bf16_bodies_match_plain(d_in, d_out, dims, rows, dev):
    """x @ W + chain(x) in bf16 against ``quanta_linear_plain``, and the
    base product with its epilogue held to ``chip_smoke.py``'s bf16 limits
    (off <= 1e-3, max_rel <= 2^-7) against fp32 x @ W plus the kernel's own
    chain, rounded once: the plain chain's fp32 products may split K
    differently at some row counts (PERF.md), which moves a delta's
    rounding, not the GEMM's."""
    gen = torch.Generator(device=dev).manual_seed(rows + d_out)
    bf = torch.bfloat16
    ad = QuantaAdapter.create(gen, d_in, d_out, dims_in=dims, dtype=bf,
                              noise_scale=0.05, device=dev)
    x = torch.randn((rows, d_in), generator=gen, device=dev).to(bf)
    w = (torch.randn((d_in, d_out), generator=gen, device=dev)
         * d_in ** -0.5).to(bf)
    before = launch_counts()["quanta_linear"]
    got = quanta_linear(x, w, ad.tensors, ad.dims_in, ad.pairs)
    torch.cuda.synchronize()
    assert launch_counts()["quanta_linear"] == before + 1
    _close(got, quanta_linear_plain(x, w, ad.tensors, ad.dims_in, ad.pairs),
           bf)
    chain = quanta_apply(x, ad.tensors, ad.dims_in, ad.pairs)
    want = (x.float() @ w.float() + chain.float()).to(bf)
    st, ok, limits = _smoke().judge("quanta_linear", got, want, bf)
    assert ok, (st, limits)
    # a second call gives the same bits (no atomics)
    assert torch.equal(got, quanta_linear(x, w, ad.tensors, ad.dims_in,
                                          ad.pairs))


@pytest.mark.parametrize("rows", [8, 40, 65, 1001])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_linear_column_shards_match_plain(rows, dtype, dev):
    """Kernel 2 on a column shard (tensor parallelism over `model`): ``w``
    holds 256 of the chain's 1024 columns from ``col``, the delta read in
    place.  Each of the four shards matches the plain version at its
    offset (float32: its columns of the whole call bit for bit, the SIMT
    tile's K order being the same); the offset ignored fails the bf16
    limits; an odd offset (bf16 reads the delta in pairs) and columns past
    the chain raise."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    d_in, d_out, n = 512, 1024, 256
    ad = QuantaAdapter.create(gen, d_in, d_out, dims_in=(8, 8, 8),
                              dtype=dtype, noise_scale=0.05, device=dev)
    x = torch.randn((rows, d_in), generator=gen, device=dev).to(dtype)
    w = (torch.randn((d_in, d_out), generator=gen, device=dev)
         * d_in ** -0.5).to(dtype)
    whole = quanta_linear(x, w, ad.tensors, ad.dims_in, ad.pairs)
    for col in range(0, d_out, n):
        wl = w[:, col:col + n].contiguous()
        got = quanta_linear(x, wl, ad.tensors, ad.dims_in, ad.pairs, col)
        want = quanta_linear_plain(x, wl, ad.tensors, ad.dims_in, ad.pairs,
                                   col)
        torch.cuda.synchronize()
        _close(got, want, dtype)
        if dtype == torch.float32:
            assert torch.equal(got, whole[:, col:col + n])
        else:
            st, ok, limits = _smoke().judge("quanta_linear", got, want,
                                            dtype)
            assert ok, (st, limits)
    if dtype == torch.bfloat16:
        wrong = quanta_linear(x, wl, ad.tensors, ad.dims_in, ad.pairs, 0)
        _, ok, _ = _smoke().judge("quanta_linear", wrong, want, dtype)
        assert not ok
        with pytest.raises(ValueError, match="even"):
            quanta_linear(x, wl, ad.tensors, ad.dims_in, ad.pairs, 1)
    with pytest.raises(ValueError, match="columns"):
        quanta_linear(x, wl, ad.tensors, ad.dims_in, ad.pairs, d_out - 8)


def test_linear_routes_on_rows_and_dtype(dev):
    """bf16 with at most 64 rows launches the decode body (partials, then
    the ordered sum), with more the wgmma tile body, float32 the SIMT
    tile; no wmma kernel remains."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ad = QuantaAdapter.create(gen, 4096, dtype=torch.bfloat16, device=dev)
    w = torch.randn((4096, 4096), generator=gen, device=dev).bfloat16()
    bodies = ("ql_wgmma_kernel", "ql_partials_kernel", "ql_sum_kernel",
              "gemm_f32_kernel")
    for rows, dtype, have in ((8, torch.bfloat16, bodies[1:3]),
                              (64, torch.bfloat16, bodies[1:3]),
                              (65, torch.bfloat16, bodies[:1]),
                              (3072, torch.bfloat16, bodies[:1]),
                              (8, torch.float32, bodies[3:])):
        x = torch.randn((rows, 4096), generator=gen, device=dev).to(dtype)
        tensors = [t.to(dtype) for t in ad.tensors]
        names = _kernel_names(lambda: quanta_linear(
            x, w.to(dtype), tensors, ad.dims_in, ad.pairs), want=have)
        assert all(k in names for k in have), names
        assert not any(k in names for k in bodies if k not in have), names
        assert "wmma" not in names and "gemm_bf16_kernel" not in names, \
            names


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


@functools.lru_cache(maxsize=None)
def _smoke():
    """``chip_smoke.py`` as a module (its ``chain_with_product``, its MoE
    reference and planted faults)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _fma_chain(x, tensors, dims, pairs):
    """The chain with each stage's sums taken as the bf16 kernel takes
    them: fp32 FMAs over k ascending from 0 (a product of two bf16 values
    is exact in fp32, so each step is one rounded add), rounded to bf16
    per stage.  cuBLAS's fp32 product, which the plain version calls,
    sums in this order at the serving shapes but splits K at some small
    ones."""
    def product(h, t):
        hf, tf = h.float(), t.float()
        acc = torch.zeros((h.shape[0], t.shape[0]), device=h.device)
        for k in range(h.shape[1]):
            acc = acc + hf[:, k:k + 1] * tf[None, :, k]
        return acc.to(h.dtype)

    return _smoke().chain_with_product(x, tensors, dims, pairs, product)


@pytest.mark.parametrize("rows", [1, 8, 9, 37, 301])
@pytest.mark.parametrize("d_in,d_out,dims,pairs", [
    (d_in, d_out, dims, None) for d_in, d_out, dims, _ in CHAINS]
    + [(64, 64, (4, 4, 2, 2), pair_schedule(4) * 2),
       # 24 stages at llama2-7b's widths: too many tensors to keep in
       # shared memory, so they stream a stage at a time
       (4096, 4096, (16, 8, 8, 4), pair_schedule(4) * 4)])
def test_bf16_chain_equals_plain_bit_for_bit(d_in, d_out, dims, pairs, rows,
                                             dev):
    """The bf16 body keeps the FMA order of the plain version's sums, so
    its output is that chain's to the bit: K not a multiple of 16 (16-8-7:
    56, 112; (4, 3, 2): 6, 8, 12), rectangular and 12-stage chains, row
    counts no tile divides, tensors streamed a stage at a time.  (The
    plain version's own sums leave that order where cuBLAS splits K, and
    over 24 stages its flips compound past any bf16 tolerance; the chains
    of ``test_chain_kernels_match_plain`` hold the kernel to it.)"""
    gen = torch.Generator(device=dev).manual_seed(rows + d_in)
    ad = QuantaAdapter.create(gen, d_in, d_out, dims_in=dims, pairs=pairs,
                              noise_scale=0.05, device=dev)
    tensors = [t.bfloat16() for t in ad.tensors]
    x = torch.randn((rows, d_in), generator=gen, device=dev).bfloat16()
    got = quanta_apply(x, tensors, ad.dims_in, ad.pairs)
    torch.cuda.synchronize()
    assert torch.equal(got, _fma_chain(x, tensors, ad.dims_in, ad.pairs))


@pytest.mark.parametrize("rows", [1, 8, 3072])
def test_streamed_bf16_chain_equals_plain_bit_for_bit(rows, dev):
    """mamba2-1.3b's widening chain (16, 16, 8) -> (32, 16, 8), whose last
    stage tensor (512 x 512, 512 KB in bf16) does not fit a block and
    streams in chunks of its outputs: at a decode tick's rows and a
    prefill wave's, kernel 1 equals its plain version bit for bit (0 ulp),
    and kernel 2 over it meets the chain phase's limits."""
    from repro_torch.kernels import smem

    gen = torch.Generator(device=dev).manual_seed(rows)
    bf = torch.bfloat16
    ad = QuantaAdapter.create(gen, 2048, 4096, dims_in=(16, 16, 8),
                              noise_scale=0.05, dtype=bf, device=dev)
    shapes = tuple(tuple(t.shape) for t in ad.tensors)
    limit = smem.device_limits(dev).smem_block
    for cap in (1, 8):
        plan = smem.chain_plan(ad.dims_in, shapes, tuple(ad.pairs), limit,
                               cap)
        assert plan.chunks[-1] < 512, plan.chunks
    x = torch.randn((rows, 2048), generator=gen, device=dev).to(bf)
    got = quanta_apply(x, ad.tensors, ad.dims_in, ad.pairs)
    torch.cuda.synchronize()
    assert torch.equal(got, apply_sequential(x, ad.tensors, ad.dims_in,
                                             ad.pairs))
    w = (torch.randn((2048, 4096), generator=gen, device=dev)
         * 2048 ** -0.5).to(bf)
    got = quanta_linear(x, w, ad.tensors, ad.dims_in, ad.pairs)
    want = quanta_linear_plain(x, w, ad.tensors, ad.dims_in, ad.pairs)
    st, ok, limits = _smoke().judge("quanta_linear", got, want, bf)
    assert ok, (st, limits)


@pytest.mark.parametrize("rows", [1, 8, 3072])
@pytest.mark.parametrize("d_in,d_out,dims,dims_out", [
    (2048, 2048, (16, 16, 8), (16, 16, 8)),
    (5120, 4096, (40, 8, 4, 4), (32, 8, 4, 4))])
def test_frontend_chains_equal_plain_bit_for_bit(d_in, d_out, dims,
                                                 dims_out, rows, dev):
    """The frontends' chains: musicgen-large's q/v 16-16-8 (its tensors
    resident beside four rows, 864 bytes under the limit) and
    pixtral-12b's rectangular q_proj (40, 8, 4, 4) -> (32, 8, 4, 4)
    (App. B; its tensors staged a stage at a time): at a decode tick's
    rows and a prefill wave's, kernel 1 equals its plain version bit for
    bit (0 ulp)."""
    gen = torch.Generator(device=dev).manual_seed(rows + d_out)
    bf = torch.bfloat16
    ad = QuantaAdapter.create(gen, d_in, d_out, dims_in=dims,
                              dims_out=dims_out, noise_scale=0.05,
                              dtype=bf, device=dev)
    x = torch.randn((rows, d_in), generator=gen, device=dev).to(bf)
    got = quanta_apply(x, ad.tensors, ad.dims_in, ad.pairs)
    torch.cuda.synchronize()
    assert torch.equal(got, apply_sequential(x, ad.tensors, ad.dims_in,
                                             ad.pairs))


def test_chain_routes_on_the_dtype(dev):
    """bf16 launches the register-tiled body, float32 the first SIMT one,
    one kernel a call."""
    gen = torch.Generator(device=dev).manual_seed(3)
    ad = QuantaAdapter.create(gen, 256, dims_in=(8, 4, 4, 2), device=dev)
    x = torch.randn((20, 256), generator=gen, device=dev)
    names = _kernel_names(lambda: quanta_apply(x, ad.tensors, ad.dims_in,
                                               ad.pairs),
                          want=("quanta_chain_kernel",))
    assert "quanta_chain_kernel" in names and "chain_bf16" not in names
    tb = [t.bfloat16() for t in ad.tensors]
    names = _kernel_names(lambda: quanta_apply(x.bfloat16(), tb, ad.dims_in,
                                               ad.pairs),
                          want=("chain_bf16_kernel",))
    assert "chain_bf16_kernel" in names and "quanta_chain" not in names


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


FWD = (
    # (b, s, h, kv, hd, window): every tail of a 64-key tile and of a
    # 128-row query tile at hd 64 and 128
    [(2, s, 4, 2, hd, None) for s in (1, 63, 64, 65, 127, 129, 300, 384)
     for hd in (64, 128)]
    + [
        (2, 100, 4, 4, 16, None),     # hd 16
        (1, 200, 8, 1, 64, None),     # MQA
        (1, 384, 14, 2, 64, 100),     # qwen2-0.5b's H / KV = 7, window
        (2, 300, 8, 2, 128, 1),       # self-only window
        # window 30: rows 93-127 of each 128-row tile see none of the
        # first key tile of their warpgroup's range
        (1, 384, 4, 4, 128, 30),
        (2, 257, 4, 1, 64, 30),
        (1, 384, 32, 32, 128, 100),   # llama2-7b's heads, window 100
    ]
)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,window", FWD)
def test_flash_forward_edges_match_plain(b, s, h, kv, hd, window, dtype,
                                         dev):
    gen = torch.Generator(device=dev).manual_seed(s * hd)
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
    before = launch_counts()["flash_attention"]
    got = FA.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    _close(got, FA.flash_attention_plain(q, k, v, window=window), dtype)


# (b, s, h, kv, hd, window): Griffin's heads (10 over 1 of 256), its
# window binding, a head_dim between 128 and 256 (padded to 256) and tails
# of a 64-key tile
FWD_256 = [(8, 384, 10, 1, 256, None), (1, 2600, 10, 1, 256, 2048),
           (2, 129, 4, 2, 256, None), (2, 65, 4, 1, 200, 30),
           (1, 300, 10, 1, 256, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,window", FWD_256)
def test_flash_forward_head_dim_256_matches_plain(b, s, h, kv, hd, window,
                                                  dtype, dev):
    """Kernel 3's head_dim-256 instance (bf16: one block an SM, PV as two
    N-128 halves; float32: eight head dims a lane) against its plain
    version; under autograd its Function gives the kernel's output and
    the banded recompute's gradients."""
    gen = torch.Generator(device=dev).manual_seed(s + hd)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    before = launch_counts()["flash_attention"]
    got = FA.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    _close(got, FA.flash_attention_plain(q, k, v, window=window), dtype)
    if s > 400:
        return
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = FA.flash_attention(qg, kg, vg, window=window, block_q=64)
    assert torch.equal(out.detach(), got)
    g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
    grads = torch.autograd.grad(out, (qg, kg, vg), g)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = FA.banded_recompute(qr, kr, vr, block_q=64, window=window,
                              scale=1.0 / math.sqrt(hd))
    for a, b_ in zip(grads, torch.autograd.grad(ref, (qr, kr, vr), g)):
        assert torch.equal(a, b_)


def test_flash_forward_bf16_refuses_head_dims_off_16_bytes(dev):
    q = torch.zeros((1, 8, 2, 12), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 8, 2, 264), device=dev)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)          # head_dim above 256
    q = torch.zeros((1, 1, 2, 256), device=dev)
    with pytest.raises(ValueError):          # the decodes stop at 128
        FA.flash_decode_attention(q, q, q, torch.ones(
            (1,), dtype=torch.int32, device=dev))
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


QMM = [
    # (rows, d_in, d_out, block_size, normalize)
    (1, 64, 24, 64, None),            # one row, one K step, narrow N
    (37, 200, 72, 64, "rowcol"),      # odd rows, K tail, norms
    (8, 4096, 4096, 64, None),        # a decode tick, split K
    (130, 1024, 300, 32, "row"),      # wide tile, two row tiles, block 32
    (5, 11008, 64, 64, "col"),        # llama2-7b's down_proj depth
]


@pytest.mark.parametrize("fmt", ["nf4", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d_in,d_out,bs,norm", QMM)
def test_quantized_matmul_matches_plain(rows, d_in, d_out, bs, norm, dtype,
                                        fmt, dev):
    gen = torch.Generator(device=dev).manual_seed(d_in + rows)
    w = torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5
    qw = quantize_linear(w.to(dtype), fmt, block_size=bs, normalize=norm)
    x = torch.randn((rows, d_in), generator=gen, device=dev).to(dtype)
    before = launch_counts()["quantized_matmul"]
    got = quantized_matmul(x, qw)
    torch.cuda.synchronize()
    assert launch_counts()["quantized_matmul"] == before + 1
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               matmul_ref(x, qw).float().cpu().numpy(), **tol)


QMM_EDGES = [
    # (rows, d_in, d_out, block_size, normalize): every row boundary of
    # the two bf16 bodies (and of the decode body's wgmma widths), K
    # tails, ragged columns (no tile and no 16-byte code row divides 24,
    # 300 or 4104; code rows of 26 and 301 bytes are not even 4-byte
    # aligned, so their codes take plain stores), each quant block and
    # each norm
    (1, 200, 24, 64, None),
    (8, 4096, 4104, 64, "row"),
    (16, 11008, 300, None, "col"),
    (17, 200, 300, 32, "rowcol"),
    (64, 4096, 24, 32, None),
    (65, 200, 4104, None, "row"),
    (128, 11008, 24, 64, "rowcol"),
    (129, 4096, 300, 64, "col"),
    (1001, 200, 4104, 32, None),
    (3072, 4096, 4104, 64, "rowcol"),
    (3072, 11008, 300, 32, "row"),
    (8, 11008, 4104, None, "rowcol"),
    (8, 200, 26, 32, "col"),
    (8, 4096, 301, 64, "rowcol"),
    (33, 200, 301, None, "row"),
    (129, 200, 26, 64, "row"),
    (65, 4096, 301, None, "col"),
]


@pytest.mark.parametrize("fmt", ["nf4", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d_in,d_out,bs,norm", QMM_EDGES)
def test_quantized_matmul_edges_match_plain(rows, d_in, d_out, bs, norm,
                                            dtype, fmt, dev):
    test_quantized_matmul_matches_plain(rows, d_in, d_out, bs, norm, dtype,
                                        fmt, dev)


def test_quantized_matmul_launches_every_bf16_body(dev):
    """Each bf16 body the plan names (decode at 1-64 rows in both of its
    wgmma widths, 8 and 64, prefill above) launches, and the counter
    moves."""
    from repro_torch.kernels.smem import device_limits, quantized_matmul_plan

    gen = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn((256, 192), generator=gen, device=dev) * 256 ** -0.5
    qw = quantize_linear(w.bfloat16(), "nf4", block_size=64)
    seen = set()
    for rows in (1, 8, 9, 33, 64, 65):
        x = torch.randn((rows, 256), generator=gen, device=dev).bfloat16()
        plan = quantized_matmul_plan(rows, 256, 192, True,
                                     device_limits(dev).sms)
        seen.add(plan.variant)
        before = launch_counts()["quantized_matmul"]
        got = quantized_matmul(x, qw)
        torch.cuda.synchronize()
        assert launch_counts()["quantized_matmul"] == before + 1
        _close(got, matmul_ref(x, qw), torch.bfloat16)
    assert seen == {0, 1}
    with pytest.raises(ValueError):          # bf16 blocks below 8 rows
        quantized_matmul(x, quantize_linear(w.bfloat16(), "nf4",
                                            block_size=4))


def _pool(n_blocks, bs, kv, hd, dtype, gen, dev):
    return (torch.randn((n_blocks, bs, kv, hd), generator=gen, device=dev)
            .to(dtype))


PAGED = [
    # (b, h, kv, hd, bs, n_b, lens, window)
    (3, 4, 2, 64, 16, 5, (1, 33, 80), None),    # GQA, tails
    (2, 8, 8, 128, 16, 32, (512, 17), 50),      # llama2-7b heads, window
    (4, 14, 2, 64, 5, 7, (35, 1, 6, 11), None),  # bs not dividing 64
]


def _tables(b, n_b, lens, bs, n_blocks, seed):
    """Shuffled pool rows per slot; entries past a slot's block count
    repeat its last row, as ``PagedCacheView.device_tables`` exports."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, n_blocks))
    t = np.zeros((b, n_b), np.int32)
    used = 0
    for i, n in enumerate(lens):
        c = -(-n // bs)
        t[i, :c] = perm[used:used + c]
        t[i, c:] = t[i, c - 1]
        used += c
    return t


@pytest.mark.parametrize("quant", [None, "nf4", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,hd,bs,n_b,lens,window", PAGED)
def test_paged_decode_kernels_match_plain(b, h, kv, hd, bs, n_b, lens,
                                          window, dtype, quant, dev):
    gen = torch.Generator(device=dev).manual_seed(hd + bs)
    n_blocks = b * n_b + 1
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(dtype)
    kp = _pool(n_blocks, bs, kv, hd, dtype, gen, dev)
    vp = _pool(n_blocks, bs, kv, hd, dtype, gen, dev)
    tables = torch.from_numpy(_tables(b, n_b, lens, bs, n_blocks, bs)).to(dev)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(window=window)
    if quant is not None:
        (kp, ks), (vp, vs) = (quantize_kv(kp, quant), quantize_kv(vp, quant))
        kw.update(kv_quant=quant, k_scales=ks, v_scales=vs)
    name = ("paged_flash_decode_attention" if quant is None
            else "paged_flash_decode_attention_quant")
    before = launch_counts()[name]
    got = FA.paged_flash_decode_attention(q, kp, vp, tables, cl, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    _close(got, FA.paged_decode_attention_plain(q, kp, vp, tables, cl, **kw),
           dtype)


def test_paged_decode_equals_dense_decode_bit_for_bit(dev):
    """A pool read through its table gives what the dense kernel gives on
    the gathered cache, bit for bit: the two share one block body and,
    the extent being the same, one split plan."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, hd, bs, n_b = 3, 8, 128, 16, 8
    kp = _pool(b * n_b + 1, bs, h, hd, torch.bfloat16, gen, dev)
    vp = _pool(b * n_b + 1, bs, h, hd, torch.bfloat16, gen, dev)
    lens = (128, 1, 77)
    tables = torch.from_numpy(_tables(b, n_b, lens, bs, b * n_b + 1, 0)).to(
        dev)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    paged = FA.paged_flash_decode_attention(q, kp, vp, tables, cl)
    dense = FA.flash_decode_attention(q, FA.gather_pages(kp, tables),
                                      FA.gather_pages(vp, tables), cl)
    assert torch.equal(paged, dense)


SPLIT = [
    # (b, h, kv, hd, extent, bs, lens, window): the bf16 split decode at
    # G 1, 7, 8 and 64, hd 64 and 128, lengths at the chunk edges; score
    # chunks of two tiles (extent 1100: the two-stage ring); head dims off
    # 16 bytes (copied element by element) and off the 32-dim value slices;
    # a slot of length 0
    (4, 8, 8, 128, 512, 16, (1, 64, 65, 512), None),
    (3, 7, 1, 64, 200, 8, (128, 129, 200), 70),
    (2, 16, 2, 128, 1100, 4, (1100, 257), None),
    (2, 16, 2, 64, 1100, 5, (1024, 1025), 300),
    (2, 64, 1, 64, 300, 12, (300, 1), 1),
    (2, 64, 1, 128, 1024, 16, (1024, 640), None),
    (3, 4, 2, 12, 150, 5, (150, 66, 0), None),
    (2, 4, 4, 100, 130, 13, (130, 64), 20),
    (2, 2, 2, 1, 64, 16, (64, 5), None),
]


@pytest.mark.parametrize("b,h,kv,hd,extent,bs,lens,window", SPLIT)
def test_split_decode_matches_plain(b, h, kv, hd, extent, bs, lens, window,
                                    dev):
    """The bf16 split decode over a dense cache and over a pool holding
    the same rows: each against its plain version, the pool equal to the
    dense cache bit for bit, two calls equal bit for bit, and one launch
    counted per call."""
    gen = torch.Generator(device=dev).manual_seed(extent + h + hd)
    bf = torch.bfloat16
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(bf)
    kc = torch.randn((b, extent, kv, hd), generator=gen, device=dev).to(bf)
    vc = torch.randn((b, extent, kv, hd), generator=gen, device=dev).to(bf)
    n_b = extent // bs
    n_blocks = b * n_b + 1
    tables = torch.from_numpy(_tables(b, n_b, [max(n, 1) for n in lens], bs,
                                      n_blocks, hd)).to(dev)
    kp = torch.zeros((n_blocks, bs, kv, hd), dtype=bf, device=dev)
    vp = torch.zeros_like(kp)
    for i, n in enumerate(lens):
        for j in range(max(1, -(-n // bs))):
            kp[tables[i, j]] = kc[i, j * bs:(j + 1) * bs]
            vp[tables[i, j]] = vc[i, j * bs:(j + 1) * bs]
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = launch_counts()
    dense = FA.flash_decode_attention(q, kc, vc, cl, window=window)
    again = FA.flash_decode_attention(q, kc, vc, cl, window=window)
    paged = FA.paged_flash_decode_attention(q, kp, vp, tables, cl,
                                            window=window)
    torch.cuda.synchronize()
    _close(dense, FA.flash_decode_attention_plain(q, kc, vc, cl,
                                                  window=window), bf)
    _close(paged, FA.paged_decode_attention_plain(q, kp, vp, tables, cl,
                                                  window=window), bf)
    assert torch.equal(dense, again) and torch.equal(paged, dense)
    assert not dense[torch.tensor(lens, device=dev) == 0].any()
    after = launch_counts()
    grew = {k: after[k] - before[k] for k in after}
    assert grew["flash_decode_attention"] == 2
    assert grew["paged_flash_decode_attention"] == 1


@pytest.mark.parametrize("window", [None, 50])
def test_split_decode_keeps_the_one_block_walks_bits(window, dev):
    """The bf16 split decode over a dense cache of NF4-decoded rows equals,
    bit for bit, the NF4 paged decode (kernel 6, one attend_block walk a
    slot) over the codes: the two passes keep that walk's arithmetic."""
    gen = torch.Generator(device=dev).manual_seed(4)
    b, h, hd, bs, n_b = 8, 8, 128, 16, 32
    lens = (33, 100, 385, 512, 1, 64, 65, 200)
    n_blocks = b * n_b + 1
    pool = [_pool(n_blocks, bs, h, hd, torch.bfloat16, gen, dev)
            for _ in range(2)]
    (kc, ks), (vc, vs) = (quantize_kv(t, "nf4") for t in pool)
    tables = torch.from_numpy(_tables(b, n_b, lens, bs, n_blocks, 2)).to(dev)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).bfloat16()
    quant = FA.paged_flash_decode_attention(
        q, kc, vc, tables, cl, window=window, kv_quant="nf4", k_scales=ks,
        v_scales=vs)
    k, v = FA.gather_kv(q, kc, vc, tables, kv_quant="nf4", k_scales=ks,
                        v_scales=vs)
    split = FA.flash_decode_attention(q, k, v, cl, window=window)
    assert torch.equal(split, quant)


@pytest.mark.parametrize("window", [None, 50])
def test_split_decode_keeps_the_one_block_walks_bits_int8(window, dev):
    """The int8 twin of the NF4 case above: the code path over int8 pools
    equals the bf16 split decode over the dense cache of the decoded rows,
    bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(5)
    b, h, hd, bs, n_b = 8, 8, 128, 16, 32
    lens = (33, 100, 385, 512, 1, 64, 65, 200)
    n_blocks = b * n_b + 1
    pool = [_pool(n_blocks, bs, h, hd, torch.bfloat16, gen, dev)
            for _ in range(2)]
    (kc, ks), (vc, vs) = (quantize_kv(t, "int8") for t in pool)
    tables = torch.from_numpy(_tables(b, n_b, lens, bs, n_blocks, 3)).to(dev)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).bfloat16()
    quant = FA.paged_flash_decode_attention(
        q, kc, vc, tables, cl, window=window, kv_quant="int8", k_scales=ks,
        v_scales=vs)
    k, v = FA.gather_kv(q, kc, vc, tables, kv_quant="int8", k_scales=ks,
                        v_scales=vs)
    split = FA.flash_decode_attention(q, k, v, cl, window=window)
    assert torch.equal(split, quant)


# (hd, quant_block, window): code rows and scales staged by cp.async (hd
# 128 / qb 64, hd 64 / qb 16, int8 at hd 48) and decoded element by element
# (NF4 rows off 16 bytes at hd 72 and 48, more scales a row than a code
# stage holds at qb 8, a quant block off 8 elements at qb 4); GQA of 4
CODE_PATHS = [(128, 64, None), (64, 16, 30), (72, 8, None), (128, 4, None),
              (48, 48, 7)]


@pytest.mark.parametrize("fmt", ["nf4", "int8"])
@pytest.mark.parametrize("hd,qb,window", CODE_PATHS)
def test_code_loader_paths_keep_the_bits(hd, qb, window, fmt, dev):
    """Both fills of the code loader give the bf16 tiles the rows would:
    the code path equals the split decode over the decoded cache bit for
    bit, and its plain version."""
    gen = torch.Generator(device=dev).manual_seed(hd + qb)
    b, h, kv, bs, n_b = 4, 8, 2, 16, 20
    lens = (1, 64, 300, 320)
    n_blocks = b * n_b + 1
    pool = [_pool(n_blocks, bs, kv, hd, torch.bfloat16, gen, dev)
            for _ in range(2)]
    (kc, ks), (vc, vs) = (quantize_kv(t, fmt, block_size=qb) for t in pool)
    tables = torch.from_numpy(_tables(b, n_b, lens, bs, n_blocks, 1)).to(dev)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).bfloat16()
    kw = dict(window=window, kv_quant=fmt, k_scales=ks, v_scales=vs,
              quant_block=qb)
    got = FA.paged_flash_decode_attention(q, kc, vc, tables, cl, **kw)
    k, v = FA.gather_kv(q, kc, vc, tables, kv_quant=fmt, k_scales=ks,
                        v_scales=vs, quant_block=qb)
    assert torch.equal(got, FA.flash_decode_attention(q, k, v, cl,
                                                      window=window))
    _close(got, FA.paged_decode_attention_plain(q, kc, vc, tables, cl, **kw),
           torch.bfloat16)


def _kernel_names(fn, want=(), sessions=3, most=12):
    """The names of the CUDA kernels that ``fn`` launches, as
    ``torch.profiler`` reads them off the card, joined over profiler
    sessions of two calls each: ``sessions`` of them, and more, up to
    ``most``, until every name in ``want`` has shown up.  Sessions now and
    then lose some or all of their kernel records, several in a row at
    times (the card tests' whole run failed so about one time in four);
    these trace the host too, as ``chip_smoke.py``'s do, and a launch the
    code path makes shows up in a later session if the earlier ones lost
    it (one it does not make shows up in none, however many run)."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for i in range(most):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        names += [e.key for e in prof.key_averages()]
        joined = " ".join(names)
        if i + 1 >= sessions and all(w in joined for w in want):
            break
    return joined


SPLIT_PASSES = ("score_pass", "value_pass")


def _decode_route_case(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((2, 1, 4, 64), generator=gen, device=dev)
    pool = torch.randn((9, 16, 2, 64), generator=gen, device=dev)
    tables = torch.from_numpy(_tables(2, 4, (64, 20), 16, 9, 0)).to(dev)
    cl = torch.tensor((64, 20), dtype=torch.int32, device=dev)
    return q, pool, tables, cl


def test_f32_and_code_decodes_keep_attend_block(dev):
    """float32 rows, and float32 queries over NF4 or int8 codes, launch
    attend_block's kernels and no pass of the split decode; bf16 queries
    over NF4 or int8 codes launch the code path's two passes and no
    attend_block kernel."""
    q, pool, tables, cl = _decode_route_case(dev)
    calls = [
        (q, "flash_decode_kernel", lambda q: FA.flash_decode_attention(
            q, FA.gather_pages(pool, tables),
            FA.gather_pages(pool, tables), cl)),
        (q, "paged_decode_kernel", lambda q: FA.paged_flash_decode_attention(
            q, pool, pool, tables, cl))]
    for fmt in ("nf4", "int8"):
        codes, scales = quantize_kv(pool, fmt)
        kw = dict(kv_quant=fmt, k_scales=scales, v_scales=scales)
        for qq in (q, q.bfloat16()):
            calls.append((qq, "paged_decode_kernel"
                          if qq.dtype == torch.float32 else "quant_",
                          lambda qq, codes=codes, kw=kw:
                          FA.paged_flash_decode_attention(
                              qq, codes, codes, tables, cl, **kw)))
    for qq, want, call in calls:
        names = _kernel_names(lambda: call(qq), want=(
            [want + p for p in SPLIT_PASSES] if want == "quant_" else [want]))
        if want == "quant_":
            assert all(want + p in names for p in SPLIT_PASSES), names
            assert "paged_decode_kernel" not in names, names
        else:
            assert want in names, names
            assert not any(p in names for p in SPLIT_PASSES), names


def test_bf16_row_decodes_launch_the_split_passes(dev):
    """bf16 rows, dense and paged, launch the split decode's score and
    value passes and none of attend_block's decode kernels."""
    q, pool, tables, cl = _decode_route_case(dev)
    q, pool = q.bfloat16(), pool.bfloat16()
    k = FA.gather_pages(pool, tables)
    for prefix, call in (
            ("dense_", lambda: FA.flash_decode_attention(q, k, k, cl)),
            ("paged_", lambda: FA.paged_flash_decode_attention(
                q, pool, pool, tables, cl))):
        names = _kernel_names(call, want=[prefix + p for p in SPLIT_PASSES])
        assert all(prefix + p in names for p in SPLIT_PASSES), names
        assert "flash_decode_kernel" not in names, names
        assert "paged_decode_kernel" not in names, names


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 64), device=dev)
    qw = quantize_linear(torch.zeros((64, 8), device=dev), "nf4")
    with pytest.raises(ValueError):          # a CPU tensor mixed in
        quantized_matmul(x.cpu(), qw)
    odd = QuantizedLinear(torch.zeros((30, 8), dtype=torch.uint8,
                                      device=dev),
                          torch.ones((1, 8), device=dev), "nf4", 64,
                          torch.float32)
    with pytest.raises(ValueError):          # d_in 60: not a multiple of 8
        quantized_matmul(torch.zeros((4, 60), device=dev), odd)
    with pytest.raises(ValueError):          # x does not fit d_in
        quantized_matmul(torch.zeros((4, 62), device=dev), odd)
    q = torch.zeros((2, 1, 2, 64), device=dev)
    pool = torch.zeros((5, 16, 2, 64), device=dev)
    tables = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    lens = torch.ones((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):          # tables on the CPU
        FA.paged_flash_decode_attention(q, pool, pool, tables.cpu(), lens)
    with pytest.raises(ValueError):          # pools of another dtype
        FA.paged_flash_decode_attention(q, pool.bfloat16(), pool.bfloat16(),
                                        tables, lens)
    codes, scales = quantize_kv(pool, "int8")
    with pytest.raises(ValueError):          # int8 codes named nf4
        FA.paged_flash_decode_attention(q, codes, codes, tables, lens,
                                        kv_quant="nf4", k_scales=scales,
                                        v_scales=scales)
    with pytest.raises(ValueError):          # decode to another dtype
        FA.paged_flash_decode_attention(q, codes, codes, tables, lens,
                                        kv_quant="int8", k_scales=scales,
                                        v_scales=scales,
                                        value_dtype=torch.bfloat16)


BANKED = [
    # (n_slots, seq, d_in, d_out, rank): decode and prefill rows, ragged
    # columns (no tile divides 200 or 4104), 2-D x (seq None), rank 64
    (8, 1, 4096, 4104, 16),
    (3, 37, 64, 200, 8),
    (4, None, 128, 96, 64),
    (2, 130, 256, 264, 4),
    (6, 1, 200, 96, 16),     # the shrink's K in 4 splits, the last of 8
]


@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,seq,d_in,d_out,rank", BANKED)
def test_banked_gather_matches_plain(n, seq, d_in, d_out, rank, dtype,
                                     a_dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(d_out)
    shape = (n, d_in) if seq is None else (n, seq, d_in)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    a = (torch.randn((5, d_in, rank), generator=gen, device=dev)
         * d_in ** -0.5).to(a_dtype)
    b = (0.1 * torch.randn((5, rank, d_out), generator=gen, device=dev)
         ).to(a_dtype)
    a[0] = 0
    b[0] = 0
    w = (torch.randn((d_in, d_out), generator=gen, device=dev)
         * d_in ** -0.5).to(dtype)
    ids = torch.tensor([2, 0, 4, 2, 1, 3, 0, 1][:n], dtype=torch.int32,
                       device=dev)
    x3 = x if seq is not None else x[:, None]
    before = launch_counts()
    got = banked_lora_delta(x, a, b, ids, scale=2.0)
    torch.cuda.synchronize()
    want = banked_lora_delta_ref(x3, a, b, ids, 2.0).reshape(got.shape)
    _close(got, want, dtype)
    assert not got[ids == 0].any()            # the neutral row adds 0
    got = banked_lora_linear(x, w, a, b, ids, scale=2.0)
    torch.cuda.synchronize()
    want = banked_lora_linear_ref(x3, w, a, b, ids, 2.0).reshape(got.shape)
    _close(got, want, dtype)
    after = launch_counts()
    assert after["banked_lora_delta"] == before["banked_lora_delta"] + 1
    assert after["banked_lora_linear"] == before["banked_lora_linear"] + 1


# (n_slots, seq, d_out): prefill tiles of 128 rows straddling slots of 97
# and of 300 rows, 97 one-row slots in one prefill body (a slot per row of
# a tile), the 8-slot decode tick, ragged columns (4104, 200: no 128- or
# 64-column tile divides them)
BANKED_BF16 = [(3, 97, 4104), (2, 300, 264), (97, 1, 200), (8, 1, 4104),
               (8, 1, 4096), (5, 12, 4096)]


def _bf16_bank(n, seq, d_out, dev, d_in=512, rank=16):
    gen = torch.Generator(device=dev).manual_seed(n * seq + d_out)
    x = torch.randn((n, seq, d_in), generator=gen, device=dev).bfloat16()
    a = torch.randn((5, d_in, rank), generator=gen, device=dev) * d_in ** -0.5
    b = 0.1 * torch.randn((5, rank, d_out), generator=gen, device=dev)
    a[0] = 0
    b[0] = 0
    w = (torch.randn((d_in, d_out), generator=gen, device=dev)
         * d_in ** -0.5).bfloat16()
    ids = torch.tensor(([2, 0, 4, 2, 1, 3, 0, 1] * 13)[:n], dtype=torch.int32,
                       device=dev)
    return x, w, a, b, ids


def _ulps_off(got, want):
    """Share of bf16 elements more than one ulp of ``want`` off."""
    _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -126))
    ulps = (got.float() - want.float()).abs() / torch.ldexp(
        torch.ones_like(want.float()), e - 8)
    return float((ulps > 1).float().mean())


@pytest.mark.parametrize("n,seq,d_out", BANKED_BF16)
def test_banked_bf16_bodies_straddle_slots(n, seq, d_out, dev):
    """The wgmma bodies (prefill and decode) against the plain version:
    each row takes its own slot's bank row wherever its tile starts, the
    bf16 limits of the card run (off <= 1e-3), and rows of the neutral id
    add an exact zero through the new epilogue."""
    x, w, a, b, ids = _bf16_bank(n, seq, d_out, dev)
    got = banked_lora_linear(x, w, a, b, ids, scale=2.0)
    want = banked_lora_linear_ref(x, w, a, b, ids, 2.0)
    torch.cuda.synchronize()
    assert _ulps_off(got, want) <= 1e-3
    _close(got, want, torch.bfloat16)
    base = banked_lora_linear(x, w, torch.zeros_like(a), torch.zeros_like(b),
                              ids, scale=2.0)
    assert torch.equal(got[ids == 0], base[ids == 0])
    # a row on another slot's bank row would read its delta
    wrong = banked_lora_linear_ref(x, w, a, b, ids.roll(1), 2.0)
    assert _ulps_off(wrong, want) > 1e-2


def test_banked_routes_on_rows_and_dtype(dev):
    """bf16 with more than 64 rows launches the prefill body, with at most
    64 the decode body and its combine, float32 the SIMT tile; the
    prefill body folds the shrink's split sum into its epilogue."""
    routes = (((8, 64, 4096), torch.bfloat16, ("fused_wgmma_kernel",),
               ("decode_gemm_kernel", "reduce_kernel")),
              ((8, 1, 4096), torch.bfloat16,
               ("decode_gemm_kernel", "combine_kernel"),
               ("fused_wgmma_kernel", "reduce_kernel")),
              ((8, 64, 256), torch.float32, ("fused_f32_kernel",),
               ("fused_wgmma_kernel", "decode_gemm_kernel")))
    for (n, seq, d_out), dtype, have, lack in routes:
        x, w, a, b, ids = _bf16_bank(n, seq, d_out, dev, d_in=4096)
        x, w = x.to(dtype), w.to(dtype)
        names = _kernel_names(lambda: banked_lora_linear(x, w, a, b, ids,
                                                         scale=1.0),
                              want=have)
        assert all(k in names for k in have), names
        assert not any(f"::{k}<" in names for k in lack), names


def test_banked_gather_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros((2, 3, 64), device=dev)
    a = torch.zeros((3, 64, 65), device=dev)
    b = torch.zeros((3, 65, 32), device=dev)
    ids = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="rank"):
        banked_lora_delta(x, a, b, ids, scale=1.0)
    a, b = a[..., :4].contiguous(), b[:, :4].contiguous()
    with pytest.raises(ValueError, match="int32"):
        banked_lora_delta(x, a, b, ids.long(), scale=1.0)
    with pytest.raises(ValueError, match="several devices"):
        banked_lora_delta(x, a, b, ids.cpu(), scale=1.0)
    with pytest.raises(ValueError, match="multiples of 8"):
        banked_lora_linear(x.bfloat16()[..., :60], torch.zeros(
            (60, 32), dtype=torch.bfloat16, device=dev), a[:, :60], b, ids,
            scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        banked_lora_delta(x.half(), a, b, ids, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,window,bq", [
    (2, 100, 4, 2, 64, None, 64),     # GQA, S not a multiple of the block
    (1, 200, 4, 4, 128, 30, 128),     # window
])
def test_flash_function_trains_through_the_kernel(b, s, h, kv, hd, window,
                                                  bq, dtype, dev):
    """With grad on, kernel 3 launches inside its autograd.Function: the
    output is the kernel's bit for bit, and dq, dk, dv are autograd of the
    plain banded recompute bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev
                           ).to(dtype).requires_grad_(True)
               for n in (h, kv, kv))
    g = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    before = launch_counts()["flash_attention"]
    out = FA.flash_attention(q, k, v, window=window, block_q=bq)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    with torch.no_grad():
        assert torch.equal(out, FA.flash_attention(q, k, v, window=window))
    rq, rk, rv = (t.detach().requires_grad_(True) for t in (q, k, v))
    rec = FA.banded_recompute(rq, rk, rv, block_q=bq, window=window,
                              scale=hd ** -0.5)
    want = torch.autograd.grad(rec, (rq, rk, rv), g)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_forward_only_kernels_refuse_autograd_on_the_card(dev):
    """A CUDA wrapper with no backward raises, and does not detach, when
    grad is on and an operand requires grad; under no_grad it launches."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ad = QuantaAdapter.create(gen, 256, n_axes=4, device=dev)
    tensors = [t.clone().requires_grad_(True) for t in ad.tensors]
    x = torch.randn((8, 256), generator=gen, device=dev)
    before = launch_counts()["quanta_apply"]
    with pytest.raises(RuntimeError, match="no backward"):
        quanta_apply(x, tensors, ad.dims_in, ad.pairs)
    with pytest.raises(RuntimeError, match="no backward"):
        quanta_linear(x, torch.zeros((256, 256), device=dev), tensors,
                      ad.dims_in, ad.pairs)
    assert launch_counts()["quanta_apply"] == before
    with torch.no_grad():
        out = quanta_apply(x, tensors, ad.dims_in, ad.pairs)
    torch.cuda.synchronize()
    assert launch_counts()["quanta_apply"] == before + 1
    _close(out, apply_sequential(x, ad.tensors, ad.dims_in, ad.pairs),
           torch.float32)


# ---------------------------------------------------------------------------
# The kernels inside a captured CUDA graph (the engine's decode tick)
# ---------------------------------------------------------------------------

def _capture(fn):
    """Warm ``fn`` up on a side stream, then capture it in a CUDA graph;
    returns the graph and the outputs it writes at every replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _graph_cases(dtype, dev):
    """(counter name, call, inputs refreshed in place between replays) of
    every kernel wrapper at a decode tick's shapes (8 rows)."""
    gen = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)
                ).to(dtype)

    ad = QuantaAdapter.create(gen, 512, 512, dims_in=(8, 8, 8), dtype=dtype,
                              noise_scale=0.05, device=dev)
    x, w = rnd(8, 512), rnd(512, 512, scale=512 ** -0.5)
    q = rnd(8, 1, 4, 64)
    kc, vc = rnd(8, 96, 2, 64), rnd(8, 96, 2, 64)
    lens = torch.tensor([1, 5, 17, 33, 64, 65, 90, 96], dtype=torch.int32,
                        device=dev)
    n_b, bs = 6, 16
    tables = torch.from_numpy(_tables(8, n_b, lens.tolist(), bs, 8 * n_b + 1,
                                      3)).to(dev)
    kp, vp = _pool(8 * n_b + 1, bs, 2, 64, dtype, gen, dev), _pool(
        8 * n_b + 1, bs, 2, 64, dtype, gen, dev)
    (kq, ks), (vq, vs) = quantize_kv(kp, "nf4"), quantize_kv(vp, "nf4")
    qw = quantize_linear(w, "nf4", block_size=64)
    a, b = rnd(5, 512, 16, scale=512 ** -0.5), rnd(5, 16, 520, scale=0.1)
    wb = rnd(512, 520, scale=512 ** -0.5)
    ids = torch.tensor([2, 0, 4, 2, 1, 3, 0, 1], dtype=torch.int32,
                       device=dev)
    s, xq, xs = rnd(2, 128, 4, 64), rnd(2, 128, 2, 64), rnd(2, 128, 2, 64)
    return [
        ("quanta_apply",
         lambda: quanta_apply(x, ad.tensors, ad.dims_in, ad.pairs), [x]),
        ("quanta_linear",
         lambda: quanta_linear(x, w, ad.tensors, ad.dims_in, ad.pairs), [x]),
        ("flash_attention", lambda: FA.flash_attention(s, xq, xs), [s]),
        ("flash_decode_attention",
         lambda: FA.flash_decode_attention(q, kc, vc, lens), [q, kc]),
        ("paged_flash_decode_attention",
         lambda: FA.paged_flash_decode_attention(q, kp, vp, tables, lens),
         [q, kp]),
        ("paged_flash_decode_attention_quant",
         lambda: FA.paged_flash_decode_attention(
             q, kq, vq, tables, lens, kv_quant="nf4", k_scales=ks,
             v_scales=vs), [q]),
        ("quantized_matmul", lambda: quantized_matmul(x, qw), [x]),
        ("banked_lora_linear",
         lambda: banked_lora_linear(x, wb, a, b, ids, scale=2.0), [x]),
        ("banked_lora_delta",
         lambda: banked_lora_delta(x, a, b, ids, scale=2.0), [x]),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", range(9))
def test_wrappers_replay_bit_for_bit_in_a_graph(index, dtype, dev):
    """Each kernel wrapper captured in a CUDA graph: its replay equals
    the eager call bit for bit, also after its inputs are refreshed in
    place; the capture and the replays count no launch (the engine adds a
    graph's launches at each replay)."""
    name, call, inputs = _graph_cases(dtype, dev)[index]
    want = call().clone()
    before = launch_counts()[name]
    graph, out = _capture(call)
    assert launch_counts()[name] == before + 2      # warm-up and capture
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want), name
    gen = torch.Generator(device=dev).manual_seed(12)
    for t in inputs:
        t.copy_(torch.randn(t.shape, generator=gen, device=dev).to(t.dtype))
    want = call().clone()
    count = launch_counts()[name]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want), name
    assert launch_counts()[name] == count


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_replays_count_launches(cache, dev):
    """A CUDA engine captures its decode tick once and replays it; each
    replay adds the graph's launches to the wrappers' counters, so kernel
    4 (or 5) counts one launch per layer per tick, and the tokens equal
    those of the same engine run eagerly."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.peft import PeftConfig, attach
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServingEngine

    cfg = get_smoke("llama2-7b-proxy").replace(attn_backend="pallas",
                                               peft_backend="pallas")
    model = build_model(cfg, device=dev)
    base, peft = attach(1, model.init(0), PeftConfig(n_axes=4), device=dev)
    outs = {}
    for eager in (False, True):
        eng = ServingEngine(model, base, peft, n_slots=3, max_len=64,
                            cache=cache, block_size=8, device=dev)
        eng._decode.eager = eager
        reqs = [Request(uid=i, prompt=[5 + i, 9, 3 * i + 1],
                        max_new_tokens=6) for i in range(5)]
        for r in reqs:
            eng.submit(r)
        reset_launch_counts()
        eng.run()
        outs[eager] = [r.output for r in reqs]
        counts = launch_counts()
        name = ("flash_decode_attention" if cache == "dense"
                else "paged_flash_decode_attention")
        assert counts[name] == cfg.n_layers * eng.stats["decode_calls"]
        assert counts["quanta_linear"] == (2 * cfg.n_layers
                                           * (eng.stats["decode_calls"]
                                              + eng.stats["prefill_calls"]))
        assert eng.compile_guard.counts() == {"decode": 0 if eager else 1}
    assert outs[False] == outs[True]


def test_engines_leave_no_memory_behind(dev):
    """Engines that captured their graph, once deleted, hold no device
    memory: the warm-up reuses one side stream (a new stream per engine
    would keep one more cuBLAS workspace each time)."""
    import gc

    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServingEngine

    model = build_model(get_smoke("llama2-7b-proxy"), device=dev)
    params = model.init(0)
    held = []
    for _ in range(3):
        eng = ServingEngine(model, params, n_slots=2, max_len=32, device=dev)
        eng.submit(Request(uid=0, prompt=[3, 4, 5], max_new_tokens=4))
        eng.run()
        del eng
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated(dev))
    assert held[2] == held[1], held


def test_engine_raises_when_a_captured_leaf_moves(dev):
    """Rebinding a cache leaf after the capture raises before the replay
    could read the old storage."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServingEngine

    model = build_model(get_smoke("llama2-7b-proxy"), device=dev)
    eng = ServingEngine(model, model.init(0), n_slots=2, max_len=32,
                        device=dev)
    eng.submit(Request(uid=0, prompt=[3, 4, 5], max_new_tokens=8))
    eng.step()
    eng.step()
    eng.cache["len"] = eng.cache["len"].clone()
    with pytest.raises(RuntimeError, match="moved since the graph"):
        eng.step()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_foldfree_bank_delta_runs_the_chain_kernel(dtype, dev, monkeypatch):
    """A bank of fold-free QuanTA tenants under the kernel backend: each
    slot's T and S chains launch kernel 1 (two launches a slot, a slot on
    the base included), the plain chain (``apply_sequential``) is never
    called, and each slot's row equals its tenant's single-tenant
    fold-free ``apply`` over the same batch bit for bit (kernel 1 keeps
    each row's sums alone)."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import quanta as Q
    from repro_torch.core.bank import AdapterBank
    from repro_torch.core.peft import PeftConfig, attach
    from repro_torch.kernels import quanta_apply as QA
    from repro_torch.models import build_model

    model = build_model(get_smoke("llama2-7b-proxy"), device=dev)
    params = model.init(0)
    tenants = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for i in range(2):
        _, aset = attach(10 + i, params, PeftConfig(n_axes=4, fold=False),
                         device=dev)
        for a in aset.flat().values():
            for t in a.tensors:
                t.add_(0.05 * torch.randn(t.shape, generator=gen,
                                          device=dev))
        tenants[f"f{i}"] = aset
    bank = AdapterBank.build(params, tenants)
    names = ("f0", None, "f1", "f0")
    ids = [bank.id_of(n) for n in names]
    banked = bank.subtree("layers", ids)["attn"]["q_proj"].layer(0)
    w = params["layers"]["attn"]["q_proj"][0].to(dtype)
    x = torch.randn((len(ids), 7, w.shape[0]), generator=gen,
                    device=dev).to(dtype)
    want = {n: tenants[n]["layers"]["attn"]["q_proj"].layer(0).apply(
        x, w, "pallas") for n in ("f0", "f1")}

    def refused(*a, **k):
        raise AssertionError("the plain chain ran on the card")

    monkeypatch.setattr(Q, "apply_sequential", refused)
    monkeypatch.setattr(QA, "apply_sequential", refused)
    before = QA.quanta_apply.launches
    got = banked.apply(x, w, "pallas")
    torch.cuda.synchronize()
    assert QA.quanta_apply.launches - before == 2 * len(ids)
    base = x @ w
    for b, name in enumerate(names):
        ref = base[b] if name is None else want[name][b]
        assert torch.equal(got[b], ref), (b, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_bank_group_runs_the_chain_kernel(dtype, dev, monkeypatch):
    """A bank-stacked folded QuanTA group under the kernel backend: each
    slot's chain launches kernel 1 once, the plain chain is never called,
    and each slot's row equals the chain kernel on that row alone bit for
    bit."""
    from repro_torch.core import quanta as Q
    from repro_torch.kernels import quanta_apply as QA

    gen = torch.Generator(device=dev).manual_seed(5)
    rows = [Q.QuantaAdapter.create(gen, 256, n_axes=4, noise_scale=0.05,
                                   device=dev) for _ in range(3)]
    group = Q.QuantaAdapter(
        tuple(torch.stack(ts) for ts in zip(*(a.tensors for a in rows))),
        rows[0].dims_in, rows[0].dims_out, rows[0].pairs)
    ids = torch.tensor([2, 0, 1, 2], device=dev)
    x = torch.randn((4, 7, 256), generator=gen, device=dev).to(dtype)
    want = [QA.quanta_apply(x[b], [t.to(dtype) for t in rows[i].tensors],
                            rows[i].dims_in, rows[i].pairs)
            for b, i in enumerate(ids.tolist())]

    def refused(*a, **k):
        raise AssertionError("the plain chain ran on the card")

    monkeypatch.setattr(Q, "apply_sequential", refused)
    monkeypatch.setattr(QA, "apply_sequential", refused)
    before = QA.quanta_apply.launches
    got = group.banked_delta(x, ids, "pallas")
    torch.cuda.synchronize()
    assert QA.quanta_apply.launches - before == len(want)
    for b, ref in enumerate(want):
        assert torch.equal(got[b], ref.to(dtype)), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,k,rows", [(8, 2, 300), (16, 1, 77)])
def test_moe_ffn_matches_every_expert_on_every_token(e, k, rows, dtype,
                                                     dev):
    """The MoE FFN's no-drop dispatch on the card against every expert on
    every token, top-k selected (``chip_smoke.dense_moe_reference``),
    within the phase-9 limit; its two planted faults exceed it."""
    smoke = _smoke()
    from repro_torch.models import moe

    d, ff = 128, 192
    gen = torch.Generator(device=dev).manual_seed(e + k)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    p = {"router": rnd(d, e, scale=d ** -0.5),
         "gate_proj": rnd(e, d, ff, scale=d ** -0.5),
         "up_proj": rnd(e, d, ff, scale=d ** -0.5),
         "down_proj": rnd(e, ff, d, scale=ff ** -0.5)}
    x = rnd(1, rows, d)
    want = smoke.dense_moe_reference(x[0], p, e, k).float()

    def rel():
        out = moe.moe_ffn(x, p, n_experts=e, top_k=k, capacity_factor=1.25,
                          no_drop=True)[0][0].float()
        return float((out - want).abs().max() / want.abs().max())

    tol = smoke.MOE_FFN_TOL if dtype == torch.bfloat16 else 1e-5
    assert rel() <= tol
    for what in smoke.MOE_FAULTS:
        with smoke.planted_moe_fault(what, e):
            assert rel() > smoke.MOE_FFN_TOL, what


def test_moe_engine_decodes_through_one_graph(dev):
    """The mixtral SMOKE model (bf16, kernel backends) served on the card:
    the MoE dispatch (sorts, searchsorted, gathers) captures with the
    rest of the decode tick as one graph, whose tokens equal the same
    engine's run eagerly, past the 48-token window."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.peft import PeftConfig, attach
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServingEngine

    cfg = get_smoke("mixtral-8x7b").replace(
        attn_backend="pallas", peft_backend="pallas",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    model = build_model(cfg, device=dev)
    base, peft = attach(1, model.init(0), PeftConfig(n_axes=3), device=dev)
    outs = {}
    for eager in (False, True):
        eng = ServingEngine(model, base, peft, n_slots=3, max_len=96,
                            device=dev)
        eng._decode.eager = eager
        reqs = [Request(uid=i, prompt=[5 + i, 9, 3 * i + 1] * (8 + 6 * i),
                        max_new_tokens=12) for i in range(4)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs[eager] = [r.output for r in reqs]
        assert eng.compile_guard.counts() == {"decode": 0 if eager else 1}
    assert outs[False] == outs[True]
    assert max(3 * (8 + 6 * i) for i in range(4)) + 12 > cfg.sliding_window


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_griffin_engine_decodes_through_one_graph(cache, dev):
    """The recurrentgemma-2b SMOKE model (bf16, kernel backends, QuanTA on
    q/v and every rec_proj) served on the card: the recurrent states'
    in-place updates, the ring write at ``(len - 1) % window`` and the
    ring attention capture with the rest of the decode tick as one graph,
    whose tokens equal the same engine's run eagerly past the 32-row
    window; kernel 3 runs each prefill wave once per macro block."""
    from repro_torch.configs import get_peft, get_smoke
    from repro_torch.core.peft import PeftConfig, attach
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServingEngine

    cfg = get_smoke("recurrentgemma-2b").replace(
        attn_backend="pallas", peft_backend="pallas",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    model = build_model(cfg, device=dev)
    peft_cfg = get_peft("recurrentgemma-2b")
    base, peft = attach(1, model.init(0), PeftConfig(
        n_axes=3, targets=peft_cfg.targets), device=dev)
    outs = {}
    for eager in (False, True):
        eng = ServingEngine(model, base, peft, n_slots=3, max_len=96,
                            cache=cache, block_size=8, device=dev)
        eng._decode.eager = eager
        reqs = [Request(uid=i, prompt=[5 + i, 9, 3 * i + 1] * (4 + 5 * i),
                        max_new_tokens=12) for i in range(4)]
        for r in reqs:
            eng.submit(r)
        reset_launch_counts()
        eng.run()
        outs[eager] = [r.output for r in reqs]
        counts = launch_counts()
        assert counts["flash_attention"] == eng.stats["prefill_calls"]
        assert counts["quanta_linear"] > 0
        assert counts["flash_decode_attention"] == 0
        assert eng.compile_guard.counts() == {"decode": 0 if eager else 1}
    assert outs[False] == outs[True]
    assert max(3 * (4 + 5 * i) for i in range(4)) + 12 > cfg.local_window


def test_bf16_train_state_saved_on_the_card_restores_bit_for_bit(
        dev, tmp_path):
    """Two bf16 training steps on the card (kernel 3 under autograd, int8
    compression on), an async save, then a restore onto the ``meta``
    template: every leaf back on the card, bit for bit, the step
    counters ints; the resumed step equals the uninterrupted one."""
    from repro_torch.checkpoint import (
        AsyncCheckpointer, restore, tree_flatten_with_paths,
    )
    from repro_torch.configs import get_smoke
    from repro_torch.core.peft import PeftConfig, attach
    from repro_torch.data import SyntheticSeq2Task
    from repro_torch.models import build_model, param_specs
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, make_train_step

    cfg = get_smoke("llama2-7b-proxy").replace(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        attn_backend="pallas")
    model = build_model(cfg, device=dev)
    peft_cfg = PeftConfig(n_axes=3)
    base, peft = attach(1, model.init(0), peft_cfg, device=dev)
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt, compress=True)
    data = SyntheticSeq2Task(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=8, task_rank=8)
    state = TrainState.create(base, peft, opt, compress=True)
    for i in range(2):
        state, _ = step(state, data.batch(i))
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(state.step, state)
    ck.close()
    tbase, tpeft = attach(1, param_specs(cfg), peft_cfg, device="meta")
    back = restore(str(tmp_path), 2, TrainState.create(
        tbase, tpeft, opt, compress=True))
    assert back.step == 2 and back.opt_state.step == 2
    got, want = (tree_flatten_with_paths(t) for t in (back, state))
    assert got[0] == want[0]
    for path, a, b in zip(got[0], got[1], want[1]):
        if isinstance(b, int):
            assert a == b, path
            continue
        assert a.device == b.device and a.dtype == b.dtype, path
        bits = (lambda t: t.view(torch.int16)) if a.dtype == torch.bfloat16 \
            else (lambda t: t)
        assert torch.equal(bits(a), bits(b)), path
    assert any(t.dtype == torch.bfloat16 for t in want[1]
               if isinstance(t, torch.Tensor))
    s1, m1 = step(state, data.batch(2))
    s2, m2 = step(back, data.batch(2))
    assert torch.equal(m1["loss"], m2["loss"])
