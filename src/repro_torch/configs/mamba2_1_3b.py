"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060]."""

import torch

from repro_torch.core.peft import PeftConfig
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_kernel=4,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    quanta_scheme="16-16-8",
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=32,
    conv_kernel=4,
)

PEFT = PeftConfig(
    method="quanta", n_axes=3, scheme=FULL.quanta_scheme,
    targets=(r".*/(x_proj|z_proj|out_proj)$",),
)
NOTES = ("Attention-free: QuanTA targets the SSD block projections "
         "(x_proj/z_proj rectangular d->2d, out_proj 2d->d) — see DESIGN.md "
         "§Arch-applicability. long_500k RUNS: O(1) SSM state decode.")
