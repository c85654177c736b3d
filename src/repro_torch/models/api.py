"""Model registry and input stand-ins (port of ``repro/models/api.py``).

``build_model(cfg)`` returns the model of every family of the JAX
package's registry: the Transformer for the dense and MoE families and
the audio (musicgen) and VLM (pixtral) frontends, Griffin for the hybrid
family, Mamba2 for the SSM one.  Each exposes ``init``, ``forward``,
``loss``, ``init_cache``, ``prefill``, ``decode_step``, ``cache_spec``
and ``insert_cache``.

``input_specs(cfg, shape)`` gives the step's ``batch`` of an (arch x
shape) cell as tensors on the ``meta`` device: the JAX package's shapes
and dtypes, the frontends' batch layout among them, and no memory.
``cache_slot_spec(cfg)`` is the decode cache's slot layout (a
``CacheLeafSpec`` per leaf, mirroring ``init_cache``).

``param_specs(cfg)`` and ``cache_specs(cfg, shape)`` are the port's
``jax.eval_shape``: the model's ``init`` and ``init_cache`` run on the
``meta`` device, with no memory, and give the JAX package's shapes and
dtypes leaf for leaf.  With ``attach`` and ``TrainState.create`` on
those specs they give ``checkpoint.restore`` its template.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.models.common import ModelConfig, ShapeConfig
from repro_torch.models.griffin import Griffin
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.transformer import Transformer

__all__ = ["build_model", "input_specs", "cache_specs", "cache_slot_spec",
           "param_specs"]


def build_model(cfg: ModelConfig, device=None
                ) -> Union[Transformer, Griffin, Mamba2]:
    """The model of ``cfg`` on ``device`` (default: the card; raises when
    there is none): Griffin for the hybrid family, Mamba2 for the SSM
    one, and the Transformer for the dense, MoE, audio and VLM ones."""
    if cfg.family == "hybrid":
        return Griffin(cfg, device=device)
    if cfg.family == "ssm":
        return Mamba2(cfg, device=device)
    return Transformer(cfg, device=device)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """``meta``-device stand-ins for the step's ``batch``: int32 tokens
    and labels, frame embeddings (audio) or patch embeddings before
    ``seq_len - n_patches`` tokens (vision) in the activation dtype
    (bf16 where the config computes in bf16, else its compute dtype).
    A decode step takes one token, or one frame embedding.  Raises for a
    vision model whose ``seq_len`` does not exceed ``n_patches``."""
    b, s = shape.global_batch, shape.seq_len
    act = cfg.compute_dtype
    tok = torch.int32

    if shape.kind == "decode":
        if cfg.frontend == "audio_tokens":
            return {"embeds": _meta((b, 1, cfg.d_model), act)}
        return {"tokens": _meta((b, 1), tok)}

    if cfg.frontend == "audio_tokens":
        batch = {"embeds": _meta((b, s, cfg.d_model), act)}
    elif cfg.frontend == "vision_embeds":
        p = cfg.n_patches
        if s <= p:
            raise ValueError(f"seq {s} must exceed n_patches {p}")
        batch = {"patch_embeds": _meta((b, p, cfg.d_model), act),
                 "tokens": _meta((b, s - p), tok)}
    else:
        batch = {"tokens": _meta((b, s), tok)}
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), tok)
    return batch


def cache_slot_spec(cfg: ModelConfig):
    """Per-leaf serving-slot layout of the decode cache
    (``CacheLeafSpec``), without building the weights."""
    return build_model(cfg, device="meta").cache_spec()


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` as ``meta`` tensors (shapes and
    dtypes of ``init``, no memory)."""
    return build_model(cfg, device="meta").init(0)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The decode cache of a (cfg x shape) cell as ``meta`` tensors:
    ``init_cache(shape.global_batch, shape.seq_len)``, no memory."""
    return build_model(cfg, device="meta").init_cache(shape.global_batch,
                                                      shape.seq_len)
