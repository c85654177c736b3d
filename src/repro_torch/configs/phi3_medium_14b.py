"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 -- RoPE SwiGLU GQA [arXiv:2404.14219]."""

import torch

from repro_torch.core.peft import PeftConfig
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10000.0,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    train_microbatches=16,
    quanta_scheme="16-8-8-5",
)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    q_block=32,
)

PEFT = PeftConfig(method="quanta", n_axes=4, scheme=FULL.quanta_scheme,
                  targets=(r".*/(q_proj|v_proj)$",))
NOTES = "long_500k skipped: pure full attention (quadratic decode cache)."
