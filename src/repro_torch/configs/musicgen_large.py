"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec frontend is a STUB: ``models.api.input_specs()`` provides
precomputed frame embeddings (B, S, d_model); the LM head predicts
codebook tokens (vocab 2048)."""

import torch

from repro_torch.core.peft import PeftConfig
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio_tokens",
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    quanta_scheme="16-16-8",
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend="audio_tokens",
    q_block=32,
)

PEFT = PeftConfig(method="quanta", n_axes=3, scheme=FULL.quanta_scheme,
                  targets=(r".*/(q_proj|v_proj)$",))
NOTES = ("Backbone only; EnCodec tokenizer/detokenizer stubbed as "
         "precomputed frame embeddings. long_500k skipped: full attention.")
