"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""

import torch

from repro_torch.core.peft import PeftConfig
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    quanta_scheme="16-16-16",
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    top_k=2,
    sliding_window=48,
    q_block=32,
)

PEFT = PeftConfig(method="quanta", n_axes=3, scheme=FULL.quanta_scheme,
                  targets=(r".*/(q_proj|v_proj)$",))
NOTES = ("Router + experts stay frozen under QuanTA (targets are attention "
         "q/v). long_500k skipped: decode cache is still O(context) in this "
         "config's full-cache serving mode.")
