"""Config registry of the port: every arch of the JAX package's registry
(``repro/configs``) -- the dense, MoE, hybrid (Griffin) and SSM (Mamba2)
families and the audio (musicgen) and VLM (pixtral) frontends -- each
with its FULL and SMOKE model configs, its PEFT config and its notes.
``ARCH_IDS`` is the assigned grid's archs, as the JAX registry defines
it (every arch but the paper's own llama2-7b-proxy base).
``get_shapes`` and ``list_cells`` give the assigned input-shape grid
(``configs/shapes.py``): each arch's runnable shapes and every (arch,
shape) cell, as the JAX registry gives them."""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.core.peft import PeftConfig
from repro_torch.models.common import ModelConfig, ShapeConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke", "get_peft", "get_shapes",
           "get_notes", "list_cells"]

# arch id -> module name, in the JAX registry's order
_MODULES: Dict[str, str] = {
    "phi3-medium-14b": "phi3_medium_14b",
    "minicpm-2b": "minicpm_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-6b": "yi_6b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "musicgen-large": "musicgen_large",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "pixtral-12b": "pixtral_12b",
    "mamba2-1.3b": "mamba2_1_3b",
    "llama2-7b-proxy": "llama2_7b_proxy",
}

ARCH_IDS: Tuple[str, ...] = tuple(k for k in _MODULES
                                  if k != "llama2-7b-proxy")


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).FULL


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def get_peft(arch: str) -> PeftConfig:
    return _module(arch).PEFT


def get_notes(arch: str) -> str:
    return getattr(_module(arch), "NOTES", "")


def get_shapes(arch: str) -> Tuple[ShapeConfig, ...]:
    return shapes_for(get_config(arch).family)


def list_cells(include_skipped: bool = False
               ) -> List[Tuple[str, ShapeConfig, bool]]:
    """All (arch, shape, runnable) cells of the assigned grid."""
    cells = []
    for arch in ARCH_IDS:
        fam = get_config(arch).family
        for shape in SHAPES:
            runnable = shape in shapes_for(fam)
            if runnable or include_skipped:
                cells.append((arch, shape, runnable))
    return cells
