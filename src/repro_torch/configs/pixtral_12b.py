"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) head_dim=128
d_ff=14336 vocab=131072 — pixtral-ViT frontend + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].

The ViT frontend is a STUB: ``models.api.input_specs()`` provides
precomputed patch embeddings (B, n_patches, d_model) which the backbone
consumes as a prefix before the text tokens.  Note attn_dim = 32*128 =
4096 != d_model — q_proj is rectangular (5120 -> 4096), exercising the
App. B construction."""

import torch

from repro_torch.core.peft import PeftConfig
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    frontend="vision_embeds",
    n_patches=1024,
    rope_theta=1_000_000_000.0,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    quanta_scheme="16-8-8-5",
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend="vision_embeds",
    n_patches=16,
    q_block=32,
)

PEFT = PeftConfig(method="quanta", n_axes=4, scheme=FULL.quanta_scheme,
                  targets=(r".*/(q_proj|v_proj)$",))
NOTES = ("Backbone only; ViT patch embedder stubbed. q_proj rectangular "
         "(5120->4096): QuanTA uses auto dims (40,8,4,4)->(32,8,4,4). "
         "long_500k skipped: full attention.")
