"""minicpm-2b [dense]: 40L d_model=2304 36H (kv=36, i.e. MHA) d_ff=5760
vocab=122753 -- WSD schedule, llama-like arch, tied embeddings
[arXiv:2404.06395].  As in the JAX package's config, without the
upstream checkpoint's muP scalings."""

import torch

from repro_torch.core.peft import PeftConfig
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    quanta_scheme="16-12-12",
)

# head_dim 18: the plain (CPU, float32) paths take it; the bf16 flash
# forward refuses it (it needs head_dim % 8 == 0)
SMOKE = ModelConfig(
    name="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=72,
    n_heads=4,
    n_kv_heads=4,
    head_dim=18,
    d_ff=144,
    vocab_size=256,
    tie_embeddings=True,
    q_block=32,
)

PEFT = PeftConfig(method="quanta", n_axes=3, scheme=FULL.quanta_scheme,
                  targets=(r".*/(q_proj|v_proj)$",))
NOTES = ("WSD (warmup-stable-decay) schedule available in repro.optim; "
         "long_500k skipped: pure full attention.")
