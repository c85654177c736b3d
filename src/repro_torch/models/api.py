"""Model registry (port of ``repro/models/api.py``): the dense, MoE and
hybrid families."""

from __future__ import annotations

from typing import Union

from repro_torch.models.common import ModelConfig
from repro_torch.models.griffin import Griffin
from repro_torch.models.transformer import Transformer

__all__ = ["build_model"]


def build_model(cfg: ModelConfig, device=None) -> Union[Transformer, Griffin]:
    """The model of ``cfg`` on ``device`` (default: the card; raises when
    there is none): the Transformer for the dense and MoE families,
    Griffin for the hybrid one; the SSM family (Mamba2) is not ported yet
    and raises."""
    if cfg.family == "hybrid":
        return Griffin(cfg, device=device)
    return Transformer(cfg, device=device)
