"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attention per 3 layers
[arXiv:2402.19427]."""

import torch

from repro_torch.core.peft import PeftConfig
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    lru_width=2560,
    attn_period=3,
    local_window=2048,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    seq_parallel_residual=True,   # recorded: needs a mesh's dp_axes
    quanta_scheme="16-16-10",
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    n_layers=4,          # 1 macro block (rec, rec, attn) + 1 recurrent tail
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    lru_width=64,
    attn_period=3,
    local_window=32,
    q_block=32,
)

PEFT = PeftConfig(
    method="quanta", n_axes=3, scheme=FULL.quanta_scheme,
    targets=(r".*/attn/(q_proj|v_proj)$", r".*/rec_proj$"),
)
NOTES = ("QuanTA adaptation: attention q/v plus the RG-LRU recurrent-branch "
         "input projection (the analogue of q/v for recurrent blocks) — see "
         "DESIGN.md §Arch-applicability. long_500k RUNS: O(1) LRU state + "
         "2048-token local-attention ring buffer.")
