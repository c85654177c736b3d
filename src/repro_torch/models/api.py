"""Model registry (port of ``repro/models/api.py``): the dense, MoE,
hybrid and SSM families."""

from __future__ import annotations

from typing import Union

from repro_torch.models.common import ModelConfig
from repro_torch.models.griffin import Griffin
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.transformer import Transformer

__all__ = ["build_model"]


def build_model(cfg: ModelConfig, device=None
                ) -> Union[Transformer, Griffin, Mamba2]:
    """The model of ``cfg`` on ``device`` (default: the card; raises when
    there is none): the Transformer for the dense and MoE families,
    Griffin for the hybrid one, Mamba2 for the SSM one; the audio and VLM
    frontends (musicgen, pixtral) are not ported yet and raise."""
    if cfg.family == "hybrid":
        return Griffin(cfg, device=device)
    if cfg.family == "ssm":
        return Mamba2(cfg, device=device)
    return Transformer(cfg, device=device)
