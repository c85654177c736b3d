"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1, early fusion
[hf:meta-llama/Llama-4 family]."""

import torch

from repro_torch.core.peft import PeftConfig
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    rope_theta=500_000.0,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    fsdp=True,   # the params sharded over the data axes on a mesh
    train_microbatches=16,
    quanta_scheme="16-8-8-5",
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    n_experts=8,
    top_k=1,
    q_block=32,
)

PEFT = PeftConfig(method="quanta", n_axes=4, scheme=FULL.quanta_scheme,
                  targets=(r".*/(q_proj|v_proj)$",))
NOTES = ("Text backbone only (early-fusion vision tower out of scope for "
         "the LM shape grid). Expert axis shards over `model` (128/16=8 "
         "experts per device). long_500k skipped: full attention.")
