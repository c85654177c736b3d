"""The port's elastic control plane (``repro_torch.train.elastic``) against
the JAX package's on the same inputs: ``plan_mesh`` over full, degraded
and refused device counts, ``StragglerMonitor`` on an injected clock, and
``ElasticController``'s recovery plans over a checkpoint directory that
either package wrote."""

import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import save as j_save
from repro.train.elastic import (
    ElasticController as JElasticController,
    StragglerMonitor as JStragglerMonitor, plan_mesh as j_plan_mesh,
)
from repro_torch.checkpoint import save
from repro_torch.train import (
    ElasticController, RecoveryPlan, StragglerMonitor, plan_mesh,
)

# (n_devices, model_parallel, global_batch, pod_size or None): the cases
# of the JAX package's own test, then more
MESH_CASES = [
    (512, 16, 256, None), (256, 16, 256, None), (232, 16, 256, None),
    (8, 16, 256, None), (448, 16, 256, None), (768, 16, 256, None),
    (513, 16, 256, None), (64, 8, 48, None), (1, 1, 1, None),
    (96, 4, 30, None), (100, 3, 7, None), (512, 8, 512, 128),
    (384, 8, 64, 128), (130, 8, 12, 64),
]


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:                            # noqa: BLE001
        return type(e).__name__, str(e)


@pytest.mark.parametrize("n,mp,gb,pod", MESH_CASES,
                         ids=[f"{c[0]}-mp{c[1]}-b{c[2]}-pod{c[3]}"
                              for c in MESH_CASES])
def test_plan_mesh_matches_jax(n, mp, gb, pod):
    kw = dict(model_parallel=mp, global_batch=gb)
    if pod is not None:
        kw["pod_size"] = pod
    got = _outcome(plan_mesh, n, **kw)
    assert got == _outcome(j_plan_mesh, n, **kw)
    if n < mp:
        assert got[0] == "ValueError"


# each a list of events: ("start"|"finish", host, step, seconds advanced
# before the event), then the query time
STRAGGLER_CASES = {
    "steady": [(e, h, s, 1.0 if h != "h2" else 1.2)
               for s in range(4) for h in ("h0", "h1", "h2")
               for e in ("start", "finish")],
    "one slow": [(e, h, s, 1.0) for s in range(4) for h in ("h0", "h1")
                 for e in ("start", "finish")]
    + [("start", "h1", 10, 0.0), ("finish", "h1", 10, 50.0)],
    "hung mid-step": [(e, h, s, 1.0) for s in range(3)
                      for h in ("a", "b", "c") for e in ("start", "finish")]
    + [("start", "b", 5, 0.0), ("start", "c", 5, 0.0)],
    "finish without start": [("finish", "x", 1, 1.0),
                             ("start", "y", 1, 0.0),
                             ("finish", "y", 1, 2.0)],
    "window rolls": [(e, "h0", s, 9.0 if s < 3 else 1.0)
                     for s in range(12) for e in ("start", "finish")]
    + [(e, "h1", s, 1.0) for s in range(12) for e in ("start", "finish")],
    "empty": [],
}


def _drive(cls, events, tail):
    t = [0.0]
    mon = cls(factor=3.0, window=4, clock=lambda: t[0])
    out = []
    for kind, host, step, dt in events:
        t[0] += dt if kind == "finish" else 0.0
        (mon.step_started if kind == "start" else mon.step_finished)(
            host, step)
        t[0] += dt if kind == "start" else 0.0
        out.append((mon.median_step_time(), mon.stragglers()))
    t[0] += tail
    out.append((mon.median_step_time(), mon.stragglers()))
    return out


@pytest.mark.parametrize("case", list(STRAGGLER_CASES))
@pytest.mark.parametrize("tail", [0.0, 100.0])
def test_straggler_monitor_matches_jax(case, tail):
    events = STRAGGLER_CASES[case]
    assert _drive(StragglerMonitor, events, tail) == _drive(
        JStragglerMonitor, events, tail)


def test_straggler_monitor_flags_as_the_jax_test_does():
    """The JAX package's own scenario: a steady fleet, then a slow host,
    then a host that hangs mid-step."""
    t = [0.0]
    mon = StragglerMonitor(factor=3.0, clock=lambda: t[0])
    for step in range(4):
        for host in ("h0", "h1", "h2"):
            mon.step_started(host, step)
            t[0] += 1.0 if host != "h2" else 1.2
            mon.step_finished(host, step)
    assert mon.stragglers() == []
    mon.step_started("h2", 10)
    t[0] += 50.0
    mon.step_finished("h2", 10)
    assert mon.stragglers() == ["h2"]
    mon.step_started("h0", 11)
    t[0] += 100.0
    assert "h0" in mon.stragglers()


# (hosts, devices_per_host, model_parallel, global_batch, failure events)
CONTROLLER_CASES = [
    (8, 64, 16, 256, [["h3"]]),
    (8, 64, 16, 256, [["h2", "h5"]]),
    (8, 64, 16, 256, [["h1"], ["h6", "h7"], ["h0"]]),
    (4, 8, 4, 32, [["h0"], ["h1"], ["h2"], ["h3"]]),
    (16, 32, 8, 128, [["h9", "h10", "h11"]]),
    (2, 4, 8, 16, [["h0"]]),
]


@pytest.mark.parametrize("writer", ["jax", "torch", None])
@pytest.mark.parametrize("case", range(len(CONTROLLER_CASES)))
def test_elastic_controller_matches_jax(case, writer, tmp_path):
    """Each failure in turn gives the same plan (or the same error), the
    restore step read from a directory either package wrote."""
    hosts, dph, mp, gb, events = CONTROLLER_CASES[case]
    ckpt = None
    if writer == "jax":
        j_save(str(tmp_path), 42, {"w": jnp.zeros(4)})
        ckpt = str(tmp_path)
    elif writer == "torch":
        save(str(tmp_path), 42, {"w": torch.zeros(4)})
        ckpt = str(tmp_path)
    kw = dict(hosts=[f"h{i}" for i in range(hosts)], devices_per_host=dph,
              model_parallel=mp, global_batch=gb, checkpoint_dir=ckpt)
    mine, theirs = ElasticController(**kw), JElasticController(**kw)
    for failed in events:
        got = _outcome(mine.on_host_failure, failed)
        want = _outcome(theirs.on_host_failure, failed)
        if got[0] == "ok":
            assert isinstance(got[1], RecoveryPlan)
            assert got[1].restore_step == (42 if ckpt else None)
            got = ("ok", tuple(vars(got[1]).values()))
            want = ("ok", tuple(vars(want[1]).values()))
        assert got == want
        assert mine.alive == theirs.alive
