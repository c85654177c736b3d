from repro_torch.models.api import (
    build_model, cache_slot_spec, cache_specs, input_specs, param_specs,
)
from repro_torch.models.common import ModelConfig, ShapeConfig
from repro_torch.models.griffin import Griffin
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.transformer import Transformer, padded_vocab

__all__ = ["build_model", "cache_slot_spec", "cache_specs", "input_specs",
           "param_specs", "ModelConfig",
           "ShapeConfig", "Griffin", "Mamba2", "Transformer", "padded_vocab"]
