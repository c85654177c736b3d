"""The error measures of ``chip_smoke.py`` on the CPU: bf16 errors read in
ulps of the plain output, and the planted rounding faults that the card
run must catch are caught by the same limits at a small size."""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core.factorize import pair_schedule
from repro_torch.core.quanta import QuantaAdapter, apply_sequential
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.smem import decode_plan

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ulps_of_bf16(smoke):
    want = torch.tensor([1.0, -3.0, 0.5, 2.0 ** -20], dtype=torch.bfloat16)
    ulp = torch.tensor([2.0 ** -7, 2.0 ** -6, 2.0 ** -8, 2.0 ** -27])
    st = smoke.error_stats(want.float() + ulp, want, torch.bfloat16)
    assert st["max_ulp"] == 1.0 and st["off"] == 0.0
    got = want.float() + ulp * torch.tensor([1.0, 3.0, 1.0, 1.0])
    st = smoke.error_stats(got, want, torch.bfloat16)
    assert st["max_ulp"] == 3.0 and st["off"] == 0.25
    with pytest.raises(AssertionError, match="non-finite"):
        smoke.error_stats(torch.full((2,), float("nan")), want[:2],
                          torch.bfloat16)


def test_planted_faults_fail_the_bf16_limits(smoke):
    """The chain left unrounded and ``p`` not cast before PV fail the
    limits that the sound plain versions meet."""
    gen = torch.Generator().manual_seed(0)
    dims, pairs = (8, 4, 4, 2), pair_schedule(4)
    ad = QuantaAdapter.create(gen, 256, dims_in=dims, dtype=torch.bfloat16,
                              noise_scale=0.05)
    x = torch.randn((64, 256), generator=gen).to(torch.bfloat16)
    chain = apply_sequential(x, ad.tensors, dims, pairs)
    _, ok, _ = smoke.judge("quanta_apply", chain, chain, torch.bfloat16)
    assert ok
    faulty = apply_sequential(x.float(), [t.float() for t in ad.tensors],
                                dims, pairs).to(torch.bfloat16)
    _, ok, _ = smoke.judge("quanta_apply", faulty, chain, torch.bfloat16)
    assert not ok

    q, k, v = (torch.randn((2, 130, 4, 32), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    want = FA.flash_attention_plain(q, k, v)
    faulty = FA.flash_attention_plain(q, k, v.float()).to(torch.bfloat16)
    _, ok, _ = smoke.judge("flash_attention", faulty, want, torch.bfloat16)
    assert not ok


def test_bound_takes_the_larger_time(smoke):
    ms, by = smoke.bound(3.35e12, 1.0, torch.bfloat16)
    assert (ms, by) == (1e3, "bytes")
    ms, by = smoke.bound(1.0, 989e12, torch.bfloat16)
    assert (ms, by) == (1e3, "operations")


def test_split_fault_fails_the_decode_limits(smoke):
    """Each slot's last chunk of the split decode's score pass dropped
    fails the bf16 limits of both decodes over rows, which the sound plain
    versions meet; slots of one chunk keep their length."""
    gen = torch.Generator().manual_seed(1)
    bf = torch.bfloat16
    b, h, hd, s_max, bs = 4, 4, 32, 256, 16
    q = torch.randn((b, 1, h, hd), generator=gen).to(bf)
    lens = torch.tensor([256, 100, 65, 1], dtype=torch.int32)
    chunk = decode_plan(s_max, hd, 1).chunk
    assert chunk == 64
    assert smoke.without_last_chunk(lens, chunk).tolist() == [192, 64, 64, 1]
    n_blocks = b * (s_max // bs) + 1
    tables = smoke.paged_tables(lens.tolist(), bs, s_max // bs, n_blocks, 0)
    kp, vp = (torch.randn((n_blocks, bs, h, hd), generator=gen).to(bf)
              for _ in range(2))
    k, v = FA.gather_kv(q, kp, vp, tables)
    for name, plain, args in (
            ("flash_decode_attention", FA.flash_decode_attention_plain,
             (q, k, v)),
            ("paged_flash_decode_attention", FA.paged_decode_attention_plain,
             (q, kp, vp, tables))):
        want = plain(*args, lens)
        _, ok, _ = smoke.judge(name, want, want, bf)
        assert ok
        faulty = plain(*args, smoke.without_last_chunk(lens, chunk))
        _, ok, _ = smoke.judge(name, faulty, want, bf)
        assert not ok


def test_new_planted_faults_fail_the_bf16_limits(smoke):
    """A chain stage storing its pair axes swapped fails the chain's
    limits; every row of the 8-slot decode tile on its first row's bank id
    fails kernel 8's."""
    from repro_torch.kernels.ref import banked_lora_linear_ref

    gen = torch.Generator().manual_seed(2)
    bf = torch.bfloat16
    dims, pairs = (8, 4, 4, 2), pair_schedule(4)
    ad = QuantaAdapter.create(gen, 256, dims_in=dims, dtype=bf,
                              noise_scale=0.05)
    x = torch.randn((64, 256), generator=gen).to(bf)
    chain = apply_sequential(x, ad.tensors, dims, pairs)
    faulty = apply_sequential(x, smoke.swapped_stage(list(ad.tensors), 3),
                              dims, pairs)
    _, ok, _ = smoke.judge("quanta_apply", faulty, chain, bf)
    assert not ok

    d, n = 256, len(smoke.BANK_IDS)
    ids = torch.tensor(smoke.BANK_IDS, dtype=torch.int32)
    x = torch.randn((n, 1, d), generator=gen).to(bf)
    w = (torch.randn((d, d), generator=gen) * d ** -0.5).to(bf)
    a = torch.randn((5, d, 16), generator=gen) * d ** -0.5
    b = 0.1 * torch.randn((5, 16, d), generator=gen)
    a[0], b[0] = 0, 0
    want = banked_lora_linear_ref(x, w, a, b, ids, 2.0)
    _, ok, _ = smoke.judge("banked_lora_linear", want, want, bf)
    assert ok
    faulty = banked_lora_linear_ref(x, w, a, b, ids[:1].expand(n), 2.0)
    _, ok, _ = smoke.judge("banked_lora_linear", faulty, want, bf)
    assert not ok


def test_kernel2_and_kernel6_faults_fail_the_bf16_limits(smoke):
    """The adapted linear's decode body without its last K split fails
    kernel 2's bf16 limits, and NF4 codes read with their two nibbles
    swapped fail kernel 6's, where the sound plain versions meet them."""
    from repro_torch.core.quantize import quantize_kv
    from repro_torch.kernels.quanta_linear import quanta_linear_plain
    from repro_torch.kernels.smem import quanta_linear_plan

    gen = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    d, dims, pairs = 256, (8, 4, 4, 2), pair_schedule(4)
    ad = QuantaAdapter.create(gen, d, dims_in=dims, dtype=bf,
                              noise_scale=0.05)
    x = torch.randn((8, d), generator=gen).to(bf)
    w = (torch.randn((d, d), generator=gen) * d ** -0.5).to(bf)
    want = quanta_linear_plain(x, w, ad.tensors, dims, pairs)
    _, ok, _ = smoke.judge("quanta_linear", want, want, bf)
    assert ok
    # 4 splits of one 64-row step at this width on 132 SMs
    assert quanta_linear_plan(8, d, d, True, 132).gsplits == 4
    chain = apply_sequential(x, ad.tensors, dims, pairs)
    faulty = smoke.last_split_dropped(x, w, chain, 132)
    assert torch.equal(faulty, (x[:, :192].float() @ w[:192].float()
                                + chain.float()).to(bf))
    _, ok, _ = smoke.judge("quanta_linear", faulty, want, bf)
    assert not ok

    b, h, hd, s_max, bs = 4, 4, 64, 256, 16
    q = torch.randn((b, 1, h, hd), generator=gen).to(bf)
    lens = torch.tensor([256, 100, 65, 1], dtype=torch.int32)
    n_blocks = b * (s_max // bs) + 1
    tables = smoke.paged_tables(lens.tolist(), bs, s_max // bs, n_blocks, 0)
    (kc, ks), (vc, vs) = (quantize_kv(torch.randn(
        (n_blocks, bs, h, hd), generator=gen).to(bf), "nf4")
        for _ in range(2))
    kw = dict(kv_quant="nf4", k_scales=ks, v_scales=vs)
    name = "paged_flash_decode_attention_quant"
    want = FA.paged_decode_attention_plain(q, kc, vc, tables, lens, **kw)
    _, ok, _ = smoke.judge(name, want, want, bf)
    assert ok
    swapped = smoke.nibbles_swapped(kc)
    assert torch.equal(smoke.nibbles_swapped(swapped), kc)
    assert int(swapped[0, 0, 0, 0]) == (int(kc[0, 0, 0, 0]) % 16) * 16 + (
        int(kc[0, 0, 0, 0]) // 16)
    faulty = FA.paged_decode_attention_plain(
        q, swapped, smoke.nibbles_swapped(vc), tables, lens, **kw)
    _, ok, _ = smoke.judge(name, faulty, want, bf)
    assert not ok


def test_column_offset_fault_and_tp_helpers(smoke):
    """Kernel 2 on a column shard: the plain version at the rank's offset
    meets the bf16 limits and equals its columns of the whole product's
    arithmetic; the planted fault (the offset ignored: the neighbour's
    columns of the delta) fails them.  Phase 17's wave is the engine's
    right-padded first wave, and its cases name kernels that exist."""
    from repro_torch import kernels
    from repro_torch.kernels.quanta_linear import quanta_linear_plain

    gen = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    d, dims, pairs = 256, (8, 4, 4, 2), pair_schedule(4)
    ad = QuantaAdapter.create(gen, d, dims_in=dims, dtype=bf,
                              noise_scale=0.05)
    x = torch.randn((40, d), generator=gen).to(bf)
    w = (torch.randn((d, d // 2), generator=gen) * d ** -0.5).to(bf)
    want = quanta_linear_plain(x, w, ad.tensors, dims, pairs, d // 2)
    chain = apply_sequential(x, ad.tensors, dims, pairs)
    assert torch.equal(want, (x.float() @ w.float()
                              + chain[:, d // 2:].float()).to(bf))
    _, ok, _ = smoke.judge("quanta_linear", want, want, bf)
    assert ok
    faulty = quanta_linear_plain(x, w, ad.tensors, dims, pairs, 0)
    _, ok, _ = smoke.judge("quanta_linear", faulty, want, bf)
    assert not ok
    toks, lens = smoke._wave([[1, 2, 3], [4] * 17, [5]])
    assert toks.shape == (3, 32) and lens.tolist() == [3, 17, 1]
    assert toks[1, :17].tolist() == [4] * 17 and not toks[1, 17:].any()
    for _, _, _, need in smoke.TP_CASES.values():
        assert set(need) <= set(kernels.KERNELS)


# kernels that run only in float32 (TF32 would change the numbers): the
# profile groups, which book the bf16 serving paths, need not name them
FLOAT32_KERNELS = {"flash_forward_kernel", "flash_decode_kernel",
                   "paged_decode_kernel", "quanta_chain_kernel",
                   "gemm_f32_kernel", "fused_f32_kernel", "qmm_f32_kernel"}


def _global_kernels():
    """Every ``__global__`` function name in the port's CUDA sources."""
    import re

    names = set()
    for src in sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu")):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    return names


def test_profile_groups_book_each_bf16_kernel_once(smoke):
    """``chip_smoke.py``'s ``PROFILE_GROUPS`` name every bf16 kernel of the
    sources in exactly one group (a kernel in two would be booked twice,
    one in none under "other"), and every float32 kernel in at most one."""
    names = _global_kernels()
    assert {"ql_wgmma_kernel", "ql_partials_kernel", "ql_sum_kernel",
            "quant_score_pass", "quant_value_pass", "decode_gemm_kernel",
            "combine_kernel", "paged_decode_kernel"} <= names
    assert "gemm_bf16_kernel" not in names
    assert FLOAT32_KERNELS <= names
    for name in sorted(names):
        groups = [g for g, subs in smoke.PROFILE_GROUPS
                  if any(sub in name for sub in subs)]
        if name in FLOAT32_KERNELS:
            assert len(groups) <= 1, (name, groups)
        else:
            assert len(groups) == 1, (name, groups)
    # and every substring names a kernel that exists
    for _, subs in smoke.PROFILE_GROUPS:
        for sub in subs:
            assert any(sub in name for name in names), sub


def test_round_bits_keeps_the_bits_asked_for(smoke):
    x = torch.randn(1000, generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16)
    assert torch.equal(smoke.round_bits(x, 8), x)
    m, _ = torch.frexp(smoke.round_bits(x, 5).float())
    assert torch.equal(m * 32, torch.round(m * 32))
    assert not torch.equal(smoke.round_bits(x, 5), x)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_grad_limit_lies_between_sound_and_coarse(smoke, window):
    """Kernel 3's Function (its plain forward here) meets the bf16
    gradient limit against the reference attention, and the same Function
    fed inputs of ``GRAD_CONTROL_CAUGHT`` significant bits exceeds it."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, g = (torch.randn((2, 130, 4, 32), generator=gen
                              ).to(torch.bfloat16) for _ in range(4))

    def fn(a, c, d):
        return FA.flash_attention(a, c, d, window=window, block_q=130)

    ref = smoke._flash_grads(lambda a, c, d: FA.blockwise_reference_attention(
        a, c, d, q_block=128, window=window), q, k, v, g)
    tol = smoke.FLASH_GRAD_TOL["torch.bfloat16"]
    assert smoke._grad_rel(smoke._flash_grads(fn, q, k, v, g), ref) <= tol
    coarse = (smoke.round_bits(t, smoke.GRAD_CONTROL_CAUGHT)
              for t in (q, k, v, g))
    assert smoke._grad_rel(smoke._flash_grads(fn, *coarse), ref) > tol


def _moe_inputs(e, d, ff, rows, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype)

    p = {"router": rnd(d, e, scale=d ** -0.5),
         "gate_proj": rnd(e, d, ff, scale=d ** -0.5),
         "up_proj": rnd(e, d, ff, scale=d ** -0.5),
         "down_proj": rnd(e, ff, d, scale=ff ** -0.5)}
    return rnd(1, rows, d), p


@pytest.mark.parametrize("e,k", [(8, 2), (16, 1)])
def test_dense_moe_reference_and_planted_faults(smoke, e, k):
    """Phase 9's reference (every expert on every token, top-k selected)
    equals the JAX package's test model of it
    (``tests/test_components.py`` ``_dense_moe_reference``) in f32; the
    no-drop MoE FFN meets the phase's limit against it in bf16, and both
    planted faults exceed it, the FFN whole again once each is lifted."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro_torch.models import moe

    x, p = _moe_inputs(e, 32, 48, 96, torch.float32)
    jp = {n: jnp.asarray(t.numpy()) for n, t in p.items()}
    xj = jnp.asarray(x[0].numpy())
    gv, gi = jax.lax.top_k(jax.nn.softmax(xj @ jp["router"], -1), k)
    gv = gv / gv.sum(-1, keepdims=True)
    h = jnp.einsum("td,edf->tef", xj, jp["gate_proj"])
    u = jnp.einsum("td,edf->tef", xj, jp["up_proj"])
    y = jnp.einsum("tef,efd->ted", jax.nn.silu(h) * u, jp["down_proj"])
    want = (jnp.take_along_axis(y, gi[:, :, None], axis=1)
            * gv[..., None]).sum(1)
    np.testing.assert_allclose(
        smoke.dense_moe_reference(x[0], p, e, k).numpy(), np.asarray(want),
        rtol=1e-5, atol=1e-5)
    xb, pb = _moe_inputs(e, 32, 48, 96, torch.bfloat16, seed=1)
    ref = smoke.dense_moe_reference(xb[0], pb, e, k).float()

    def rel():
        out = moe.moe_ffn(xb, pb, n_experts=e, top_k=k, capacity_factor=1.25,
                          no_drop=True)[0][0].float()
        return float((out - ref).abs().max() / ref.abs().max())

    sound = rel()
    assert sound <= smoke.MOE_FFN_TOL
    for what in smoke.MOE_FAULTS:
        with smoke.planted_moe_fault(what, e):
            assert rel() > smoke.MOE_FFN_TOL, what
        assert rel() == sound


def test_recorded_routing_sees_each_layer_and_restores(smoke):
    """The routing recorder of phase 9 sees one call a layer, with the
    experts the FFN picked and each token's top-k gap, and puts
    ``top_k_gates`` back."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model, moe

    real = moe.top_k_gates
    cfg = get_smoke("mixtral-8x7b")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    with smoke.recorded_routing() as calls:
        model.forward(params, {"tokens": toks})
    assert moe.top_k_gates is real
    assert len(calls) == cfg.n_layers
    for idx, gap in calls:
        assert idx.shape == (1, 24, cfg.top_k) and gap.shape == (1, 24)
        assert bool((gap >= 0).all())


def test_pinned_routing_replays_the_recorded_experts(smoke):
    """A prefill under ``pinned_routing`` of a recorded run picks that
    run's experts in every layer: the same model gives the same logits,
    another model (its router changed) routes as the recorded one did."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    cfg = get_smoke("llama4-maverick-400b-a17b")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    batch, lens = {"tokens": toks}, torch.tensor([12, 7])
    with smoke.recorded_routing() as calls:
        want, _ = model.prefill(params, None, batch, lengths=lens)
    with smoke.pinned_routing(calls):
        got, _ = model.prefill(params, None, batch, lengths=lens)
    assert torch.equal(got, want)
    other = dict(params, layers=dict(params["layers"], moe=dict(
        params["layers"]["moe"],
        router=params["layers"]["moe"]["router"].flip(-1))))
    with smoke.recorded_routing() as free:
        model.prefill(other, None, batch, lengths=lens)
    with smoke.pinned_routing(calls), smoke.recorded_routing() as pinned:
        model.prefill(other, None, batch, lengths=lens)
    assert any(not torch.equal(a, b) for (a, _), (b, _) in zip(calls, free))
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(calls, pinned))


def test_correct_sums_is_a_sum_order_control(smoke):
    """Under ``correct_sums`` the plain decode takes its fp32 product sums
    correctly rounded: the same arithmetic in another sum order, within
    the bf16 max_rel limit of the plain version (and off from it by a
    share that the phase-9 long-window checks take as their floor);
    ``torch.einsum`` is itself again afterwards."""
    real = torch.einsum
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(4, 1, 8, 64, generator=gen).to(torch.bfloat16)
    kc = torch.randn(4, 256, 2, 64, generator=gen).to(torch.bfloat16)
    vc = torch.randn(4, 256, 2, 64, generator=gen).to(torch.bfloat16)
    lens = torch.tensor([256, 100, 7, 200], dtype=torch.int32)
    want = FA.flash_decode_attention_plain(q, kc, vc, lens, window=64)
    with smoke.correct_sums():
        control = FA.flash_decode_attention_plain(q, kc, vc, lens, window=64)
    assert torch.einsum is real
    st = smoke.error_stats(control, want, torch.bfloat16)
    assert st["max_rel"] <= 2 ** -7
    _, ok, limits = smoke.judge("flash_decode_attention", control, want,
                                torch.bfloat16, off_floor=st["off"])
    assert ok and "control" in limits


def test_griffin_phase_helpers(smoke):
    """Phase 10's helpers: Griffin attends in one layer of each macro
    block (8 of recurrentgemma-2b's 26), its serving path runs no decode
    kernel (its ring decode is plain PyTorch), and its QuanTA takes the
    config's targets (q/v and every rec_proj); the dense family keeps
    q/v and every kernel."""
    from repro_torch.configs import get_config, get_peft
    from repro_torch.core.peft import PeftConfig

    griffin, llama = (get_config(a) for a in ("recurrentgemma-2b",
                                              "llama2-7b-proxy"))
    assert smoke._attn_layers(griffin) == 8
    assert smoke._attn_layers(llama) == 32
    assert smoke._path_kernels(griffin, smoke.DENSE_KERNELS) == (
        "quanta_apply", "quanta_linear", "flash_attention")
    assert smoke._path_kernels(llama, smoke.DENSE_KERNELS) == \
        smoke.DENSE_KERNELS
    assert smoke._quanta(griffin, 3).targets == get_peft(
        "recurrentgemma-2b").targets
    assert smoke._quanta(llama, 4).targets == PeftConfig().targets
    assert smoke._quanta(griffin, 3).scheme == "16-16-10"


def test_mamba2_phase_helpers(smoke):
    """Phase 11's helpers: Mamba2 attends nowhere, its serving path runs
    kernels 1 and 2 and no attention kernel, an attention kernel launched
    on its runs is a failure, its QuanTA and LoRA tenants take the
    config's targets (x_proj, z_proj, out_proj) at its 3-axis scheme, and
    its serve limit is the constant set from the plain versions'
    reading, which the planted fault's 1.245 exceeds."""
    from repro_torch.configs import get_config, get_peft

    mamba = get_config("mamba2-1.3b")
    assert smoke._attn_layers(mamba) == 0
    assert smoke._path_kernels(mamba, smoke.DENSE_KERNELS) == (
        "quanta_apply", "quanta_linear")
    targets = get_peft("mamba2-1.3b").targets
    assert smoke._quanta(mamba, 3).targets == targets
    assert smoke._quanta(mamba, 3).scheme == "16-16-8"
    assert smoke._targets(mamba) == dict(targets=targets)
    assert smoke._targets_text(mamba) == "x_proj, z_proj and out_proj"
    before = list(smoke.FAILURES)
    run = dict.fromkeys(smoke.ATTENTION_KERNELS, 0)
    smoke._no_attention(mamba, run, "quiet")
    assert smoke.FAILURES == before
    smoke._no_attention(mamba, dict(run, flash_attention=1), "busy")
    assert len(smoke.FAILURES) == len(before) + 1
    del smoke.FAILURES[len(before):]
    assert smoke.SERVE_LOGIT_TOL < smoke.SSM_SERVE_LOGIT_TOL < 1.245
    assert smoke.MAMBA2_LONG == (16384, 5000)


def test_half_head_dim_fault_fails_the_hd256_limits(smoke):
    """Kernel 3's planted fault at head_dim 256, QK^T over the first 128
    columns only, fails its bf16 limits, while the correctly summed
    control meets the floor it sets (twice its own share)."""
    gen = torch.Generator().manual_seed(5)
    bf16 = torch.bfloat16
    q, k, v = (torch.randn(shape, generator=gen).to(bf16) for shape in
               ((1, 96, 4, 256), (1, 96, 1, 256), (1, 96, 1, 256)))
    want = FA.flash_attention_plain(q, k, v, window=40)
    half = q.clone()
    half[..., 128:] = 0
    fault = FA.flash_attention_plain(half, k, v, window=40,
                                     softmax_scale=1 / 16)
    with smoke.correct_sums():
        control = FA.flash_attention_plain(q, k, v, window=40)
    floor = smoke.LONG_OFF_FACTOR * smoke.error_stats(control, want,
                                                      bf16)["off"]
    _, ok, _ = smoke.judge("flash_attention", fault, want, bf16, floor)
    assert not ok
    _, ok, _ = smoke.judge("flash_attention", control, want, bf16, floor)
    assert ok


def test_frontend_units_and_their_judge(smoke):
    """Phase 12's launch table: each FULL run of musicgen-large and
    pixtral-12b names its kernels a unit (kernels 1 and 2 once per q/v
    target and layer, 3 once a wave, 4 once a step or tick, 7 on the
    seven projections of an NF4 base, 8 on pixtral's bank; 5 and 6 in no
    run), and ``judge_units`` passes exact counts and fails a count off
    by one, a kernel off its run's path, a run with no units and a
    missing run."""
    from repro_torch.configs import get_config

    music, pix = (get_config(a) for a in smoke.FRONTENDS)
    mu, pu = smoke.frontend_units(music), smoke.frontend_units(pix)
    assert mu["wave"] == dict(quanta_apply=96, quanta_linear=96,
                              flash_attention=48)
    assert mu["NF4-base decode steps"] == dict(
        quanta_apply=96, quantized_matmul=336, flash_decode_attention=48)
    assert pu["replay engine"] == dict(quanta_apply=80, quanta_linear=80,
                                       flash_decode_attention=40)
    assert pu["bank engine"]["banked_lora_linear"] == 80
    assert pu["NF4-base engine"]["quantized_matmul"] == 280
    for units, extra in ((mu, ()), (pu, ("banked_lora_linear",
                                         "banked_lora_delta"))):
        used = {k for per in units.values() for k in per}
        assert used == {"quanta_apply", "quanta_linear", "flash_attention",
                        "flash_decode_attention", "quantized_matmul",
                        *extra}
        assert not used & set(smoke.FRONTEND_IDLE)
    assert not any("flash_attention" in pu[k] for k in pu if "engine" in k)

    def exact(units, n=3):
        return {label: ({k: v * n for k, v in per.items()}, n)
                for label, per in units.items()}

    def failures(runs):
        before = len(smoke.FAILURES)
        smoke.judge_units(pix, runs, "cpu")
        found = smoke.FAILURES[before:]
        del smoke.FAILURES[before:]
        return found

    assert failures(exact(pu)) == []
    runs = exact(pu)
    runs["wave"][0]["flash_attention"] -= 1
    assert failures(runs)
    runs = exact(pu)
    runs["replay engine"][0]["flash_attention"] = 3
    assert failures(runs)
    runs = exact(pu)
    runs["bank engine"] = ({}, 0)
    assert failures(runs)
    runs = exact(pu)
    del runs["NF4-base engine"]
    assert failures(runs)


@pytest.mark.parametrize("h,hd", [(2, 64), (4, 128)])
def test_scale_block_fault_fails_the_kernel6_limits(smoke, h, hd):
    """NF4 KV scales read one block over fail kernel 6's bf16 limits at
    head_dim 64, where a head has one 64-element scale block (the scales
    move across the token's heads: rolling a head's one block would be
    the identity), as at 128 (along each head's blocks)."""
    from repro_torch.core.quantize import quantize_kv

    gen = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    b, s_max, bs = 4, 128, 16
    q = torch.randn((b, 1, h, hd), generator=gen).to(bf)
    lens = torch.tensor([128, 100, 65, 1], dtype=torch.int32)
    n_blocks = b * (s_max // bs) + 1
    tables = smoke.paged_tables(lens.tolist(), bs, s_max // bs, n_blocks, 0)
    (kc, ks), (vc, vs) = (quantize_kv(torch.randn(
        (n_blocks, bs, h, hd), generator=gen).to(bf), "nf4")
        for _ in range(2))
    assert ks.shape[-2:] == (h, hd // 64)
    off_k, off_v = smoke.scales_off_by_one(ks), smoke.scales_off_by_one(vs)
    assert not torch.equal(off_k, ks)
    if hd // 64 > 1:
        assert torch.equal(off_k, ks.roll(1, dims=-1))
    name = "paged_flash_decode_attention_quant"
    want = FA.paged_decode_attention_plain(q, kc, vc, tables, lens,
                                           kv_quant="nf4", k_scales=ks,
                                           v_scales=vs)
    faulty = FA.paged_decode_attention_plain(q, kc, vc, tables, lens,
                                             kv_quant="nf4", k_scales=off_k,
                                             v_scales=off_v)
    _, ok, _ = smoke.judge(name, want, want, bf)
    assert ok
    _, ok, _ = smoke.judge(name, faulty, want, bf)
    assert not ok


def test_leaf_diff_reads_bits_paths_and_the_worst_leaf(smoke):
    """Phase 13's comparison: equal trees are equal bit for bit; a
    changed tensor leaf, a changed step counter and a changed dtype are
    each seen, the worst relative difference at its path."""
    from repro_torch.optim import AdamWState

    def tree(w, step=3, dtype=torch.bfloat16):
        return AdamWState(step=step, mu={"b": torch.ones(3, dtype=dtype),
                                         "a": w}, nu={})

    w = torch.arange(4.0)
    assert smoke.leaf_diff(tree(w), tree(w.clone())) == (True, 3, 3, 0.0,
                                                         None)
    paths_ok, same, n, worst, where = smoke.leaf_diff(
        tree(w + torch.tensor([0.0, 0.0, 0.0, 0.3])), tree(w))
    assert (paths_ok, same, n, where) == (True, 2, 3, ".mu/a")
    assert worst == pytest.approx(0.1)
    assert smoke.leaf_diff(tree(w, step=4), tree(w))[1:] == (
        2, 3, float("inf"), ".step")
    assert smoke.leaf_diff(tree(w, dtype=torch.float32), tree(w))[1] == 2
