"""Training runtime (port of ``repro/train``): train state and the
train/eval step builders.  Elastic control and pipeline parallelism wait
for the mesh slice."""

from repro_torch.train.loop import TrainState, make_eval_step, make_train_step
