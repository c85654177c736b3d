"""Config registry of the port: the two dense configs it runs so far."""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

__all__ = ["get_config", "get_smoke"]

_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "llama2-7b-proxy": "llama2_7b_proxy",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).FULL


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
