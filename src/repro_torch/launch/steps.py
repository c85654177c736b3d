"""Step-function factory (port of ``repro/launch/steps.py``) shared by the
launcher, the planners and the tests.

Builds each (arch x shape) cell's entry point:

* ``train`` -- the fine-tuning step (forward and backward with respect to
  the adapters, AdamW), microbatched per the shape config and the arch's
  ``train_microbatches``; data-parallel over ``dp_axes`` of ``mesh``;
* ``prefill`` -- the full-sequence forward that fills the cache and
  returns the last position's logits only;
* ``decode`` -- one token against the cache.

Shapes come without memory: :func:`build_state_specs` builds the train
state on ``meta`` (``models.param_specs``, ``attach`` and AdamW there),
``CellPrograms.batch_specs`` are ``models.input_specs`` and
``CellPrograms.cache_specs()`` the cache on ``meta``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.peft import PeftConfig, attach
from repro_torch.models.api import build_model, input_specs, param_specs
from repro_torch.models.common import ModelConfig, ShapeConfig
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import linear_warmup_schedule
from repro_torch.train.loop import TrainState, make_train_step

__all__ = ["CellPrograms", "build_programs", "build_state_specs",
           "default_optimizer"]


def default_optimizer() -> AdamW:
    # paper Tables E.2-E.4: AdamW and a linear schedule, lr 1e-4, wd 0
    return AdamW(lr=linear_warmup_schedule(1e-4, total_steps=1000,
                                           warmup_steps=30))


def build_state_specs(cfg: ModelConfig, peft_cfg: PeftConfig,
                      optimizer: Optional[AdamW] = None) -> TrainState:
    """The ``TrainState`` of ``cfg`` adapted by ``peft_cfg``, its tensors
    on ``meta`` (shapes and dtypes, no memory)."""
    opt = optimizer or default_optimizer()
    base, peft = attach(0, param_specs(cfg), peft_cfg, device="meta")
    return TrainState.create(base, peft, opt)


@dataclasses.dataclass
class CellPrograms:
    cfg: ModelConfig
    shape: ShapeConfig
    model: Any
    optimizer: AdamW
    step_fn: Callable
    batch_specs: Dict[str, torch.Tensor]
    kind: str

    def state_specs(self, peft_cfg: PeftConfig) -> TrainState:
        return build_state_specs(self.cfg, peft_cfg, self.optimizer)

    def cache_specs(self) -> Dict[str, torch.Tensor]:
        return self.model.init_cache(self.shape.global_batch,
                                     self.shape.seq_len, device="meta")


def build_programs(cfg: ModelConfig, shape: ShapeConfig,
                   dp_axes: Optional[Tuple[str, ...]] = ("pod", "data"),
                   mesh=None, device=None) -> CellPrograms:
    """The cell's step on a model on ``device`` (the card by default;
    ``"meta"`` for shapes alone).  The train step is data-parallel over
    the ``dp_axes`` that ``mesh`` has, when a mesh is given."""
    model = build_model(cfg, device=device)
    optimizer = default_optimizer()
    if shape.kind == "train":
        microbatches = max(shape.microbatches, cfg.train_microbatches)
        step = make_train_step(
            model, optimizer, microbatches=microbatches,
            dp_axes=dp_axes if mesh is not None else None, mesh=mesh)
    elif shape.kind == "prefill":
        def step(params, peft, batch):
            logits, cache = model.prefill(params, peft, batch)
            return logits[:, -1:], cache
    elif shape.kind == "decode":
        def step(params, peft, cache, batch):
            return model.decode_step(params, peft, cache, batch)
    else:
        raise ValueError(f"unknown shape kind {shape.kind}")
    return CellPrograms(cfg=cfg, shape=shape, model=model,
                        optimizer=optimizer, step_fn=step,
                        batch_specs=input_specs(cfg, shape), kind=shape.kind)
