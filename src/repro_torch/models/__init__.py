from repro_torch.models.api import build_model
from repro_torch.models.common import ModelConfig
from repro_torch.models.griffin import Griffin
from repro_torch.models.transformer import Transformer, padded_vocab

__all__ = ["build_model", "ModelConfig", "Griffin", "Transformer",
           "padded_vocab"]
