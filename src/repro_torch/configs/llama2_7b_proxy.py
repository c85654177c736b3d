"""llama2-7b (the paper's own base model): 32L d_model=4096 32H (MHA)
d_ff=11008 vocab=32000 [arXiv:2307.09288]; QuanTA scheme 16-8-8-4 on
q_proj/v_proj (the paper's 0.041% trainable-parameter setting)."""

import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama2-7b-proxy",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    quanta_scheme="16-8-8-4",
)

SMOKE = ModelConfig(
    name="llama2-7b-proxy-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=176,
    vocab_size=256,
    q_block=32,
)
