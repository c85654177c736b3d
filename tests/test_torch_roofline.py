"""``repro_torch.launch.roofline`` against ``repro.launch.roofline``: for
every arch of ``ARCH_IDS`` at FULL width and every shape of its family,
the analytic functions (``active_param_count``, ``model_flops`` and the
four adjustments, under ``attn_backend="pallas"``, the paged cache and
NF4/int8 base and KV) equal the JAX package's exactly; ``roofline_terms``
on the same cost dicts equals the JAX package's hardware-free fields, its
time terms the counts over the H100's data-sheet peaks; the analytic
count tracks the port's ``param_specs``; and the attention adjustment at
the port's kernel tiles (64-row query blocks, 64-key tiles) equals the
JAX arithmetic at those tiles."""

import math

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import roofline as J
from repro.models.common import ShapeConfig as JShape
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import shapes_for
from repro_torch.kernels import smem
from repro_torch.launch import roofline as T
from repro_torch.models import param_specs

CELLS = [(arch, s) for arch in ARCH_IDS
         for s in shapes_for(get_config(arch).family)]
# the cfg variants each adjustment reads
VARIANTS = {
    "reference": {},
    "pallas": {"attn_backend": "pallas"},
    "paged": {"kv_cache": "paged"},
    "paged occupancy 0.3": {"kv_cache": "paged", "kv_occupancy": 0.3},
    "nf4 base": {"base_quant": "nf4"},
    "int8 base": {"base_quant": "int8"},
    "paged nf4 kv": {"kv_cache": "paged", "kv_quant": "nf4"},
    "paged int8 kv": {"kv_cache": "paged", "kv_quant": "int8"},
    "pallas, paged, nf4 base and kv": {
        "attn_backend": "pallas", "kv_cache": "paged",
        "base_quant": "nf4", "kv_quant": "nf4"},
}
# the record fields that hold no hardware rate
HW_FREE = ("attn_backend", "attn_adjustment", "kv_cache",
           "paged_adjustment", "base_quant", "quantized_adjustment",
           "kv_quant", "quantized_kv_adjustment", "hlo_flops_per_device",
           "hlo_flops", "hlo_bytes_per_device", "hlo_bytes",
           "collective_bytes_per_device", "collective_breakdown",
           "model_flops", "useful_flop_ratio")


def _pair(arch, shape, **kw):
    jshape = JShape(shape.name, seq_len=shape.seq_len,
                    global_batch=shape.global_batch, kind=shape.kind,
                    microbatches=shape.microbatches)
    return (get_config(arch).replace(**kw), shape,
            j_get_config(arch).replace(**kw), jshape)


def _ids(cells):
    return [f"{a}-{s.name}" for a, s in cells]


@pytest.mark.parametrize("arch,shape", CELLS, ids=_ids(CELLS))
def test_analytic_terms_equal_jax(arch, shape):
    cfg, sh, jcfg, jsh = _pair(arch, shape)
    assert T.active_param_count(cfg) == J.active_param_count(jcfg)
    assert T.model_flops(cfg, sh) == J.model_flops(jcfg, jsh)
    for kw in VARIANTS.values():
        cfg, sh, jcfg, jsh = _pair(arch, shape, **kw)
        tiles = (cfg.q_block, cfg.kv_block)
        assert (T.attention_backend_adjustment(cfg, sh, *tiles)
                == J.attention_backend_adjustment(jcfg, jsh)), kw
        for name in ("paged_cache_adjustment", "quantized_base_adjustment",
                     "quantized_kv_adjustment"):
            assert (getattr(T, name)(cfg, sh)
                    == getattr(J, name)(jcfg, jsh)), (name, kw)


@pytest.mark.parametrize("arch,shape", CELLS, ids=_ids(CELLS))
def test_roofline_terms_equal_jax(arch, shape):
    """The JAX convention (no ``device_shape``: savings over the chips,
    the config's tiles) gives the JAX record's hardware-free fields;
    the time terms are the counts over ``HW``."""
    cost = {"flops": 3.5e15, "bytes accessed": 2.25e13}
    coll = {"all-gather": 0, "all-reduce": 7 * 2 ** 20,
            "reduce-scatter": 3 * 2 ** 20, "all-to-all": 0,
            "collective-permute": 0}
    for kw in VARIANTS.values():
        cfg, sh, jcfg, jsh = _pair(arch, shape, **kw)
        got = T.roofline_terms(cfg, sh, 256, cost, coll)
        want = J.roofline_terms(jcfg, jsh, 256, cost, coll)
        assert set(want) <= set(got)
        for k in HW_FREE:
            assert got[k] == want[k], (k, kw)
        flops, nbytes = got["hlo_flops_per_device"], got[
            "hlo_bytes_per_device"]
        assert got["compute_s"] == flops / T.peak_flops(cfg.compute_dtype)
        assert got["memory_s"] == nbytes / 3.35e12
        assert got["collective_s"] == 10 * 2 ** 20 / 450e9
        assert got["step_time_bound_s"] == max(
            got["compute_s"], got["memory_s"], got["collective_s"])
        assert got["dominant"] + "_s" in ("compute_s", "memory_s")


def test_h100_peaks_and_the_slowest_unit():
    assert T.HW["peak_flops"] == 989e12 and T.HW["hbm_bw"] == 3.35e12
    assert T.peak_flops(torch.bfloat16) == 989e12
    assert T.peak_flops("torch.float32") == 67e12
    with pytest.raises(ValueError):
        T.peak_flops(torch.int8)
    # bf16 and f32 run on different units: the slower one bounds
    assert T.compute_seconds({"torch.bfloat16": 989e12,
                              "torch.float32": 6.7e12}) == 1.0
    assert T.compute_seconds({"torch.bfloat16": 98.9e12,
                              "torch.float32": 67e12}) == 1.0
    # an f32 cut is billed at the f32 peak
    cfg = get_config("qwen2-0.5b").replace(compute_dtype=torch.float32)
    shape = shapes_for("dense")[1]
    out = T.roofline_terms(cfg, shape, 1, {"flops": 67e12}, {})
    assert out["compute_s"] == 1.0
    with pytest.raises(ValueError, match="unknown collective"):
        T.parse_collective_bytes({"all-reduce": 1, "broadcast": 2})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_param_count_tracks_param_specs(arch):
    """Within 5% of the port's parameter tree (the analytic model drops
    norms and small vectors), as the JAX package's own test holds it."""
    cfg = get_config(arch)
    analytic = T.active_param_count(cfg)["total"]
    leaves, stack = [], [param_specs(cfg)]
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(v.values())
        else:
            leaves.append(v)
    actual = sum(math.prod(t.shape) for t in leaves)
    assert abs(analytic - actual) / actual < 0.05, (arch, analytic, actual)


@pytest.mark.parametrize("arch,shape", CELLS, ids=_ids(CELLS))
def test_attention_adjustment_at_the_kernel_tiles(arch, shape):
    """By default the adjustment bills kernel 3's 64 x 64 tiles (and the
    decodes' 64-key tiles): the JAX arithmetic with those tiles."""
    assert (smem.FWD_ROWS, smem.ATTN_KEYS) == (64, 64)
    cfg, sh, jcfg, jsh = _pair(arch, shape, attn_backend="pallas")
    got = T.attention_backend_adjustment(cfg, sh)
    want = J.attention_backend_adjustment(
        jcfg.replace(q_block=smem.FWD_ROWS, kv_block=smem.ATTN_KEYS), jsh)
    assert got == want
    if got is not None and shape.kind != "decode":
        window = (cfg.local_window if cfg.family == "hybrid"
                  else cfg.sliding_window)
        # kernel 3's walk: block i visits tiles [j_lo, j_hi]
        n = -(-shape.seq_len // 64)
        tiles = sum(min(i, n - 1) - (0 if window is None else
                                     max(0, (64 * i - window + 1) // 64)) + 1
                    for i in range(n))
        assert got["visible_block_fraction"] == tiles / (n * n)


def test_device_shape_bills_the_rank_whole():
    """The port's convention: a device runs ``device_shape`` whole with
    whole weights, so every saving comes off undivided; the JAX one
    divides the sharded savings by the chips."""
    cfg = get_config("llama2-7b-proxy").replace(
        attn_backend="pallas", kv_cache="paged", base_quant="nf4",
        kv_quant="nf4")
    shape = shapes_for("dense")[2]                      # decode_32k
    dev = shape.__class__(shape.name, seq_len=shape.seq_len,
                          global_batch=8, kind="decode")
    cost = {"flops": 1e14, "bytes accessed": 5e13}
    got = T.roofline_terms(cfg, shape, 256, cost, {}, device_shape=dev)
    saved = (T.attention_backend_adjustment(cfg, dev)["score_bytes_saved"]
             + T.paged_cache_adjustment(cfg, dev)["kv_bytes_saved"]
             + T.quantized_base_adjustment(cfg, dev)["weight_bytes_saved"]
             + T.quantized_kv_adjustment(cfg, dev)["kv_bytes_saved"])
    assert got["hlo_bytes_per_device"] == pytest.approx(5e13 - saved,
                                                        rel=1e-12)
    assert got["model_flops"] == T.model_flops(cfg, shape)
