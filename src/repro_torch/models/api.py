"""Model registry (port of ``repro/models/api.py``, dense and MoE
families)."""

from __future__ import annotations

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Transformer

__all__ = ["build_model"]


def build_model(cfg: ModelConfig, device=None) -> Transformer:
    """The model of ``cfg`` on ``device`` (default: the card; raises when
    there is none): the Transformer for the dense and MoE families; the
    other families (Griffin, Mamba2) are not ported yet and raise."""
    return Transformer(cfg, device=device)

