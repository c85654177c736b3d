from repro_torch.models.api import build_model
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Transformer, padded_vocab

__all__ = ["build_model", "ModelConfig", "Transformer", "padded_vocab"]
