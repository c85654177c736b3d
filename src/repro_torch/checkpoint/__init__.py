"""Fault-tolerant checkpointing (port of ``repro/checkpoint``): atomic
manifests, crc32 per leaf, async save, restore into ``meta``-device
templates, in the JAX package's on-disk format."""

from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    latest_step,
    restore,
    restore_resharded,
    save,
    tree_flatten_with_paths,
)
