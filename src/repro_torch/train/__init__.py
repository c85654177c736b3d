"""Training runtime (port of ``repro/train``): train state, the
train/eval step builders and elastic control.  Pipeline parallelism
waits for the mesh slice."""

from repro_torch.train.loop import TrainState, make_eval_step, make_train_step
from repro_torch.train.elastic import (
    ElasticController, RecoveryPlan, StragglerMonitor, plan_mesh,
)
