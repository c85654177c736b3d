"""Training runtime (port of ``repro/train``): train state, the
train and eval steps (data-parallel over a mesh's data axes), elastic
control and the GPipe pipeline over a mesh ``stage`` axis."""

from repro_torch.train.loop import TrainState, make_eval_step, make_train_step
from repro_torch.train.elastic import (
    ElasticController, RecoveryPlan, StragglerMonitor, plan_mesh,
)
from repro_torch.train.pipeline import bubble_fraction, pipeline_apply
