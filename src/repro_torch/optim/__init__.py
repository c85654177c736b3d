"""Optimizer substrate (port of ``repro/optim``): AdamW, schedules,
clipping and int8 gradient compression with error feedback."""

from repro_torch.optim.adamw import (
    AdamW, AdamWState, clip_by_global_norm, global_norm,
)
from repro_torch.optim.compress import (
    ErrorFeedbackState, compress_int8, compressed_psum, decompress_int8,
    ef_compress_grads, ef_init,
)
from repro_torch.optim.schedules import (
    constant_schedule, linear_warmup_schedule, wsd_schedule,
)
