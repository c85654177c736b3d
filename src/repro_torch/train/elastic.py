"""Elastic scaling + straggler mitigation control plane (port of
``repro/train/elastic.py``, pure Python, as it is there).

Real pre-emption cannot be exercised in a single-host container, so the
*decision logic* is implemented as pure, clock-injected, unit-tested
components; the mechanism hooks (checkpoint restore onto a new mesh,
deterministic data re-sharding) are real and tested:

* :func:`plan_mesh` — given the surviving chip count, pick the largest
  valid ``(pod, data, model)`` mesh that preserves the model-parallel
  degree (weights keep fitting) and keeps the batch shardable.
* :class:`StragglerMonitor` — per-host heartbeat tracker; flags hosts whose
  step completion exceeds ``factor x`` the rolling median (the standard
  straggler heuristic).  Deterministic data sharding
  (``repro_torch.data``) means a flagged host can be dropped and its shard
  re-dealt without replaying or skipping a single token.
* :class:`ElasticController` — failure-event state machine: on host loss it
  emits a (new mesh, checkpoint step, shard remap) recovery plan; the
  restore itself is ``repro_torch.checkpoint.restore_resharded`` (onto
  one device, or a ``DeviceMesh`` with a spec tree).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["plan_mesh", "StragglerMonitor", "ElasticController", "RecoveryPlan"]


def plan_mesh(
    n_devices: int,
    *,
    model_parallel: int,
    global_batch: int,
    pod_size: int = 256,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest usable mesh for ``n_devices`` chips.

    Keeps ``model`` fixed (sharded weights must keep fitting), uses whole
    pods on the ``pod`` axis when possible, and drops remainder chips so
    ``data`` stays a divisor of the global batch.
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot host model_parallel={model_parallel}"
        )
    n_pods, rem = divmod(n_devices, pod_size)
    if n_pods >= 2 and rem == 0:
        data = pod_size // model_parallel
        return (n_pods, data, model_parallel), ("pod", "data", "model")
    usable = n_devices - (n_devices % model_parallel)
    data = usable // model_parallel
    # batch must divide across the data axis
    while data > 1 and global_batch % data:
        data -= 1
    return (data, model_parallel), ("data", "model")


class StragglerMonitor:
    """Flags hosts whose step time exceeds ``factor`` x the fleet median."""

    def __init__(self, factor: float = 3.0, window: int = 16,
                 clock: Callable[[], float] = time.monotonic):
        self.factor = factor
        self.window = window
        self.clock = clock
        self._start: Dict[Tuple[str, int], float] = {}
        self._durations: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window)
        )

    def step_started(self, host: str, step: int) -> None:
        self._start[(host, step)] = self.clock()

    def step_finished(self, host: str, step: int) -> None:
        t0 = self._start.pop((host, step), None)
        if t0 is not None:
            self._durations[host].append(self.clock() - t0)

    def median_step_time(self) -> Optional[float]:
        all_times = sorted(
            t for d in self._durations.values() for t in d
        )
        if not all_times:
            return None
        return all_times[len(all_times) // 2]

    def stragglers(self) -> List[str]:
        med = self.median_step_time()
        if med is None or med <= 0:
            return []
        out = []
        for host, times in self._durations.items():
            if times and times[-1] > self.factor * med:
                out.append(host)
        # a host that started a step and never finished within factor*median
        now = self.clock()
        for (host, _step), t0 in self._start.items():
            if now - t0 > self.factor * med and host not in out:
                out.append(host)
        return sorted(out)


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    restore_step: Optional[int]
    data_shards: int
    dropped_hosts: Tuple[str, ...]


class ElasticController:
    """Failure-event state machine -> recovery plan.

    Mechanisms invoked by the plan (all implemented + tested):
    checkpoint restore with re-sharding (``restore_resharded``), the
    deterministic data pipeline (shards are a pure function of
    ``(shard_id, n_shards, step)``), and mesh rebuild (``plan_mesh``).
    """

    def __init__(self, *, hosts: Sequence[str], devices_per_host: int,
                 model_parallel: int, global_batch: int,
                 checkpoint_dir: Optional[str] = None):
        self.alive = set(hosts)
        self.devices_per_host = devices_per_host
        self.model_parallel = model_parallel
        self.global_batch = global_batch
        self.checkpoint_dir = checkpoint_dir

    def on_host_failure(self, failed: Sequence[str]) -> RecoveryPlan:
        self.alive -= set(failed)
        if not self.alive:
            raise RuntimeError("all hosts lost")
        n_devices = len(self.alive) * self.devices_per_host
        shape, axes = plan_mesh(
            n_devices,
            model_parallel=self.model_parallel,
            global_batch=self.global_batch,
        )
        restore_step = None
        if self.checkpoint_dir is not None:
            from repro_torch.checkpoint.store import latest_step
            restore_step = latest_step(self.checkpoint_dir)
        data_shards = 1
        for dim, name in zip(shape, axes):
            if name in ("pod", "data"):
                data_shards *= dim
        return RecoveryPlan(
            mesh_shape=shape, mesh_axes=axes, restore_step=restore_step,
            data_shards=data_shards, dropped_hosts=tuple(sorted(failed)),
        )
