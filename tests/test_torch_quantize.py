"""The port's blockwise NF4/int8 quantization held against the JAX package:
codes, scales and packed bytes equal bit for bit (2-D and layer-stacked
weights, remainder blocks, KV rows, both nibble layouts), dequantization
equal in f32, ``block_size=None`` against numpy, the quantized matmul's
plain version against the JAX Pallas kernel in interpret mode (f32 at
5e-5: the interpret kernel and ``matmul_ref`` already differ by 1.3e-5),
and the port's engine serving an NF4/int8 base token for token as the JAX
engine does (llama2-7b-proxy and qwen2-0.5b SMOKE)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import quantize as JQ
from repro.core.peft import (
    PeftConfig as JPeftConfig, attach as j_attach, merge_all as j_merge_all,
)
from repro.kernels.quantized_matmul import (
    quantized_matmul as j_quantized_matmul, quantized_vmem_ok,
)
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest, ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_peft, get_smoke
from repro_torch.core import quantize as TQ
from repro_torch.core.peft import merge_all
from repro_torch.kernels import launch_counts
from repro_torch.kernels.quantized_matmul import quantized_matmul
from repro_torch.models import build_model
from repro_torch.serve import Request, ServingEngine

FORMATS = ["nf4", "int8"]
# (shape, block_size): 2-D, a remainder block (176 = 2*64 + 48), stacked
WEIGHTS = [((128, 48), 64), ((176, 40), 64), ((3, 96, 24), 32)]


def _w(shape, seed=0):
    return (np.random.RandomState(seed).standard_normal(shape) * 0.05
            ).astype(np.float32)


def _port(qw):
    return interop.quantized_linear_from_numpy(
        jax.tree_util.tree_map(np.asarray, qw), "cpu")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape,bs", WEIGHTS)
def test_weight_codes_and_scales_equal_jax(shape, bs, fmt):
    w = _w(shape)
    jq = JQ.quantize_linear(jnp.asarray(w), fmt, block_size=bs)
    tq = TQ.quantize_linear(torch.from_numpy(w), fmt, block_size=bs)
    assert tq.shape == tuple(jq.shape) and tq.fmt == fmt
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(TQ.dequantize(tq).numpy(),
                                  np.asarray(JQ.dequantize(jq)))
    assert TQ.quantized_nbytes(tq) == JQ.quantized_nbytes(jq)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("normalize", ["row", "col", "rowcol"])
def test_normalized_weights_match_jax(normalize, fmt):
    """The RMS norms are sums in another order: held at a tolerance.  The
    decode of JAX's own codes and norms is exact."""
    w = _w((3, 128, 40), seed=1)
    jq = JQ.quantize_linear(jnp.asarray(w), fmt, normalize=normalize)
    tq = TQ.quantize_linear(torch.from_numpy(w), fmt, normalize=normalize)
    for name in ("row_norm", "col_norm"):
        j, t = getattr(jq, name), getattr(tq, name)
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    np.testing.assert_array_equal(TQ.dequantize(_port(jq)).numpy(),
                                  np.asarray(JQ.dequantize(jq)))
    np.testing.assert_allclose(TQ.dequantize(tq).numpy(),
                               np.asarray(JQ.dequantize(jq)), atol=1e-6)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("d,qb", [(16, 64), (96, 64), (128, 64), (128, 32)])
def test_kv_codes_equal_jax(d, qb, fmt):
    """KV rows: ``ceil(d / qb)`` scales per row (one padded block at the
    SMOKE head_dim of 16), codes and the fake-quantized round trip."""
    x = np.random.RandomState(d).standard_normal((4, 5, 2, d)).astype(
        np.float32)
    jc, js = JQ.quantize_kv(jnp.asarray(x), fmt, block_size=qb)
    tc, ts = TQ.quantize_kv(torch.from_numpy(x), fmt, block_size=qb)
    assert ts.shape[-1] == -(-d // qb)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.fake_quantize_kv(torch.from_numpy(x), fmt, block_size=qb).numpy(),
        np.asarray(JQ.fake_quantize_kv(jnp.asarray(x), fmt, block_size=qb)))


def test_nibble_layouts():
    """Weights pack along d_in (high nibble = even row), KV rows along
    head_dim (high nibble = even element): -1 is code 0 and +1 code 15."""
    sign = np.where(np.arange(8) % 2, 1.0, -1.0).astype(np.float32)
    w = np.repeat(sign[:, None], 3, axis=1)                  # (8, 3)
    tq = TQ.quantize_linear(torch.from_numpy(w), "nf4")
    assert tq.packed.shape == (4, 3) and (tq.packed == 0x0F).all()
    np.testing.assert_array_equal(
        tq.packed.numpy(),
        np.asarray(JQ.quantize_linear(jnp.asarray(w), "nf4").packed))
    codes, _ = TQ.quantize_kv(torch.from_numpy(sign[None]), "nf4")
    assert codes.shape == (1, 4) and (codes == 0x0F).all()
    # the KV layout of w.T is the weight layout of w, transposed
    kv_codes, _ = TQ.quantize_kv(torch.from_numpy(w.T.copy()), "nf4")
    np.testing.assert_array_equal(kv_codes.numpy(), tq.packed.numpy().T)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_block_size_none_is_one_block_against_numpy(axis):
    """``block_size=None`` makes the whole axis one block (the documented
    meaning; the JAX ``expand_scales`` fails on it under jax 0.9)."""
    x = _w((12, 10), seed=3)
    want = np.maximum(np.abs(x).max(axis=axis, keepdims=True), 1e-12) / 127.0
    s = TQ.blockwise_scales(torch.from_numpy(x), None, axis=axis)
    np.testing.assert_array_equal(s.numpy(), want.astype(np.float32))
    n = x.shape[axis]
    full = TQ.expand_scales(s, None, n, axis=axis).numpy()
    np.testing.assert_array_equal(full, np.broadcast_to(want, x.shape))
    np.testing.assert_array_equal(
        TQ.blockwise_round(torch.from_numpy(x), s, None, axis=axis).numpy(),
        np.clip(np.round(x / np.broadcast_to(want, x.shape)), -127, 127))
    qw = TQ.quantize_linear(torch.from_numpy(x), "int8", block_size=None)
    assert qw.scales.shape == (1, 10)
    np.testing.assert_allclose(TQ.dequantize(qw).numpy(), x,
                               atol=float(want.max()))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("normalize", [None, "rowcol"])
def test_quantized_matmul_plain_matches_jax_kernel(normalize, fmt):
    """The kernel's plain version (the wrapper on CPU tensors) against the
    JAX Pallas kernel in interpret mode and JAX's ``matmul_ref``, f32 at
    5e-5, at widths where JAX's VMEM gate lets its kernel run."""
    jq = JQ.quantize_linear(jnp.asarray(_w((128, 256), seed=4)), fmt,
                            normalize=normalize)
    assert quantized_vmem_ok(jq, 128, 512, dtype_bytes=4)
    x = np.random.RandomState(5).standard_normal((2, 9, 128)).astype(
        np.float32)
    want = np.asarray(j_quantized_matmul(jnp.asarray(x), jq, interpret=True))
    before = launch_counts()
    got = quantized_matmul(torch.from_numpy(x), _port(jq))
    assert launch_counts() == before          # CPU tensors launch nothing
    assert got.shape == (2, 9, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JQ.matmul_ref(jnp.asarray(x), jq)),
        rtol=5e-5, atol=5e-5)


def test_quantize_params_targets_and_is_idempotent():
    model = build_model(get_smoke("qwen2-0.5b"), device="cpu")
    params = model.init(0)
    q = TQ.quantize_params(params, "nf4")
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        leaf = q["layers"]["attn"][name]
        assert isinstance(leaf, TQ.QuantizedLinear)
        assert leaf.shape == tuple(params["layers"]["attn"][name].shape)
    assert isinstance(q["layers"]["attn"]["q_bias"], torch.Tensor)
    assert q["embed"]["tokens"] is params["embed"]["tokens"]
    again = TQ.quantize_params(q, "int8")
    assert again["layers"]["mlp"]["up_proj"] is q["layers"]["mlp"]["up_proj"]


# ------------------------------------------------------------ engine parity
PROMPTS = [[3, 141, 59] * 3, [26, 5], [35, 89, 79, 32] * 4, [38, 46],
           [2, 7, 18]]
# (case, base_quant, engine options)
BASE_CASES = {
    "nf4 dense": ("nf4", dict()),
    "int8 dense": ("int8", dict()),
    "nf4 paged": ("nf4", dict(cache="paged", block_size=8)),
    "int8 paged": ("int8", dict(cache="paged", block_size=8)),
}


@functools.lru_cache(maxsize=None)
def _jax_weights(arch):
    model = j_build_model(j_get_smoke(arch))
    params = model.init(jax.random.PRNGKey(0))
    base, peft = j_attach(jax.random.PRNGKey(1), params,
                          JPeftConfig(method="quanta",
                                      n_axes=get_peft(arch).n_axes))
    rs = np.random.RandomState(3)
    peft = jax.tree_util.tree_map(
        lambda t: t + jnp.asarray(0.05 * rs.standard_normal(t.shape),
                                  t.dtype), peft)
    return model, base, peft


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, case, which):
    model, base, peft = _jax_weights(arch)
    fmt, opts = BASE_CASES[case]
    params, adapters = ((base, peft) if which == "adapted"
                        else (j_merge_all(base, peft), None))
    eng = JEngine(model, params, adapters, n_slots=4, max_len=64,
                  admission="prefill", base_quant=fmt, **opts)
    reqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.output for r in reqs], eng.stats["param_bytes"]


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("which", ["adapted", "merged"])
@pytest.mark.parametrize("case", list(BASE_CASES))
@pytest.mark.parametrize("arch", ["llama2-7b-proxy", "qwen2-0.5b"])
def test_quantized_base_engine_tokens_match_jax(arch, case, which, backend):
    want, j_param_bytes = _jax_tokens(arch, case, which)
    _, base, peft = _jax_weights(arch)
    fmt, opts = BASE_CASES[case]
    model = build_model(get_smoke(arch).replace(attn_backend=backend,
                                                peft_backend=backend),
                        device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    tpeft = interop.adapter_set_from_numpy(peft, "cpu")
    if which == "merged":
        tbase, tpeft = merge_all(tbase, tpeft), None
    eng = ServingEngine(model, tbase, tpeft, n_slots=4, max_len=64,
                        base_quant=fmt, device="cpu", **opts)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=8)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert [r.output for r in reqs] == want
    assert eng.stats["param_bytes"] == j_param_bytes
    assert isinstance(eng.params["layers"]["mlp"]["down_proj"],
                      TQ.QuantizedLinear)


def test_engine_quant_options_are_checked():
    model = build_model(get_smoke("llama2-7b-proxy"), device="cpu")
    params = model.init(0)
    with pytest.raises(ValueError, match="requires the model cfg"):
        ServingEngine(model, params, n_slots=2, max_len=32, kv_quant="nf4",
                      device="cpu")
    mq = build_model(get_smoke("llama2-7b-proxy").replace(kv_quant="int8"),
                     device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        ServingEngine(mq, params, n_slots=2, max_len=32, kv_quant="nf4",
                      device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        ServingEngine(mq, params, n_slots=2, max_len=32, kv_quant="fp8",
                      device="cpu")
