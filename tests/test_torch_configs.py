"""The port's config registry against the JAX package's: the five dense
archs (llama2-7b-proxy, qwen2-0.5b, yi-6b, phi3-medium-14b, minicpm-2b),
the two MoE archs (mixtral-8x7b, llama4-maverick-400b-a17b), the hybrid
one (recurrentgemma-2b) and the SSM one (mamba2-1.3b) serve
``get_config``, ``get_smoke``, ``get_peft`` and ``get_notes``, each value
equal to its JAX twin's field for field (the MoE, hybrid and SSM fields
and ``fsdp`` among them),
with ``jnp`` dtypes mapped to ``torch``'s; the RoPE tables of yi-6b's
base (5e6) equal the JAX package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro_torch import configs
from repro_torch.models import common as tcommon

DENSE = ["llama2-7b-proxy", "qwen2-0.5b", "yi-6b", "phi3-medium-14b",
         "minicpm-2b"]
MOE = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]
HYBRID = ["recurrentgemma-2b"]
SSM = ["mamba2-1.3b"]
ARCHS = DENSE + MOE + HYBRID + SSM
# the frontends' configs are held against the JAX registry's in
# tests/test_torch_frontends.py (over ARCH_IDS)
AUDIO = ["musicgen-large"]
VLM = ["pixtral-12b"]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _same(t_value, j_value):
    if j_value in DTYPES:
        return t_value is DTYPES[j_value]
    return t_value == j_value


@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_configs_equal_jax(arch, which):
    """Every field of the port's ModelConfig equals the JAX twin's field of
    that name; the JAX fields the port lacks belong to families it does
    not run, and hold their defaults."""
    got, want = getattr(configs, which)(arch), getattr(jconfigs, which)(arch)
    t_fields = {f.name for f in dataclasses.fields(got)}
    for name in t_fields:
        assert _same(getattr(got, name), getattr(want, name)), name
    defaults = type(want)(name="x", family="dense", n_layers=1, d_model=8,
                          n_heads=1, n_kv_heads=1, head_dim=8, d_ff=8,
                          vocab_size=8)
    for f in dataclasses.fields(want):
        if f.name not in t_fields:
            assert getattr(want, f.name) == getattr(defaults, f.name), f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_peft_and_notes_equal_jax(arch):
    got, want = configs.get_peft(arch), jconfigs.get_peft(arch)
    for f in dataclasses.fields(got):
        if f.name == "dtype":
            assert got.dtype is DTYPES[want.dtype]
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert configs.get_notes(arch) == jconfigs.get_notes(arch) != ""


def test_registry_covers_the_dense_family():
    """Every arch of the JAX registry, family by family, and nothing else:
    an unknown arch raises."""
    for family, archs in (("dense", DENSE), ("moe", MOE),
                          ("hybrid", HYBRID), ("ssm", SSM),
                          ("audio", AUDIO), ("vlm", VLM)):
        assert sorted(archs) == sorted(
            a for a in jconfigs._MODULES
            if jconfigs.get_config(a).family == family)
    assert configs.get_config("phi3-medium-14b").train_microbatches == 16
    assert configs.get_config("yi-6b").train_microbatches == 0
    llama4 = configs.get_config("llama4-maverick-400b-a17b")
    assert llama4.fsdp and llama4.is_moe and llama4.train_microbatches == 16
    assert configs.get_smoke("mixtral-8x7b").sliding_window == 48
    assert not configs.get_config("yi-6b").is_moe
    griffin = configs.get_config("recurrentgemma-2b")
    assert (griffin.head_dim, griffin.local_window, griffin.lru_width,
            griffin.attn_period, griffin.conv_kernel) == (256, 2048, 2560,
                                                           3, 4)
    assert griffin.seq_parallel_residual and not griffin.fsdp
    assert configs.get_peft("recurrentgemma-2b").targets == (
        r".*/attn/(q_proj|v_proj)$", r".*/rec_proj$")
    mamba = configs.get_config("mamba2-1.3b")
    assert (mamba.ssm_state, mamba.ssm_head_dim, mamba.ssm_expand,
            mamba.ssm_chunk, mamba.conv_kernel) == (128, 64, 2, 256, 4)
    assert configs.get_smoke("mamba2-1.3b").ssm_chunk == 32
    assert configs.get_peft("mamba2-1.3b").targets == (
        r".*/(x_proj|z_proj|out_proj)$",)
    assert sorted(jconfigs._MODULES) == sorted(ARCHS + AUDIO + VLM)
    pixtral = configs.get_config("pixtral-12b")
    assert (pixtral.frontend, pixtral.n_patches, pixtral.attn_dim) == (
        "vision_embeds", 1024, 4096)
    assert configs.get_config("musicgen-large").frontend == "audio_tokens"
    with pytest.raises(KeyError, match="no-such-arch"):
        configs.get_peft("no-such-arch")


def test_rope_tables_take_the_configs_base():
    """yi-6b's RoPE base reaches the tables as the JAX package builds
    them: float32 powers of a Python scalar base, which differ from JAX's
    in the last bit now and then, so the tables agree within 1e-5 at every
    position below 4096 (an angle of 4096 radians carries a float32 ulp
    of 4.9e-4); the default base gives other tables."""
    theta = configs.get_config("yi-6b").rope_theta
    assert theta == 5_000_000.0
    pos = np.arange(0, 4096, 37, dtype=np.int32)[None, :]
    jc, js = jcommon.make_rope(jnp.asarray(pos), 128, theta)
    tc, ts = tcommon.make_rope(torch.from_numpy(pos), 128, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    base, _ = tcommon.make_rope(torch.from_numpy(pos), 128, 10000.0)
    assert not torch.allclose(base, tc)
