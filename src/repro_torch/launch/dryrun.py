"""Dry run: every (arch x shape x mesh) cell of the port's step, billed on
the ``meta`` device against the H100 roofline (port of
``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch ID|all] [--shape NAME|all]
        [--mesh single|multi|both] [--out DIR] [--skip-existing]

The JAX package lowers and compiles each cell with XLA on 512 fake host
devices and reads FLOPs, bytes and collectives from the HLO.  Here each
cell runs the port's own step (``launch/steps.build_programs``) on the
``meta`` device: nothing is allocated and nothing runs on a card.  A
``fake`` process group of the mesh's size (256 or 512 ranks, rank 0)
stands in for the cluster, so ``make_production_mesh`` builds the real
``DeviceMesh`` and the train step's ``all_reduce``s are dispatched, and
``launch/op_cost.py`` counts FLOPs by dtype, bytes, collectives and the
live memory; ``launch/roofline.py`` turns the counts into H100 terms.

What a cell bills is what the port's step does on one device:

* train: the data-parallel step (``make_train_step(dp_axes, mesh)``):
  this rank's rows of each microbatch (a microbatch's rows are padded to
  a multiple of the data shards where they do not split, as GSPMD pads
  an uneven split; the record says so) and the gradient ``all_reduce``
  over each data axis (``pod``, ``data``); counted at 2 and 3
  microbatches and extrapolated (``op_cost.affine``);
* prefill and decode: this data rank's slots (``global_batch / dp``,
  rounded up) at the cache's full length, with whole weights.

The ``model`` axis is replicated in the port (the ranks of a data shard
repeat its work; ``PERF.md`` section 7), so a device's FLOPs at ``(16,
16)`` are 16 times the JAX package's tensor-parallel ones; the record's
``hlo_flops`` (a device's times the chips) shows it against
``model_flops``.  JAX's ``decode_shardings`` and ``cache_seq_shard``
have no counterpart: the port does not place weights or caches that way.

Each cell runs the reference program (``attn_backend="reference"``,
``peft_backend="reference"``, ``base_quant`` and ``kv_quant`` off), as
the JAX dry run lowers it: a kernel launch is opaque to the counter, and
the roofline's adjustments rebill what the kernels skip.  Records go to
``--out`` (``build/dryrun`` by default), one JSON file a cell.
Importing this module touches no process group.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_peft, get_shapes
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import dp_axes, dp_size, make_production_mesh
from repro_torch.launch.op_cost import affine, count
from repro_torch.launch.roofline import (
    HW, parse_collective_bytes, roofline_terms,
)
from repro_torch.launch.steps import build_programs

__all__ = ["fake_world", "cell_cost", "lower_cell", "main"]


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks (this process rank 0)
    for the duration, when there is no process group; the one that
    stands is used as it is.  Raises when this torch has no ``fake``
    backend or no ``FakeStore``."""
    if dist.is_initialized():
        yield
        return
    if "fake" not in dist.Backend.backend_list:
        raise RuntimeError("torch.distributed has no 'fake' backend: the "
                           "dry run needs it to build a mesh of "
                           f"{world} ranks in one process")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs torch.testing._internal."
                           f"distributed.fake_pg.FakeStore: {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _reference(cfg):
    """The program the counter can see: no kernel, fp weights and cache;
    the config's ``train_microbatches`` is applied by the caller."""
    return cfg.replace(attn_backend="reference", peft_backend="reference",
                       base_quant=None, kv_quant=None, train_microbatches=0)


def cell_cost(cfg, peft_cfg, shape, mesh=None) -> Dict[str, Any]:
    """One device's counts of the (``cfg`` x ``shape``) cell's step on the
    ``meta`` device (``op_cost.count``), and ``device_shape``: the share
    of the cell that device's program runs.  ``mesh``: a ``DeviceMesh``
    over the process group (the data-parallel train step, and the data
    rank's slots), or ``None`` for one device."""
    low = _reference(cfg)
    dp = dp_size(mesh) if mesh is not None else 1
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        m = max(shape.microbatches, cfg.train_microbatches, 1)
        rows = shape.global_batch // m          # a microbatch's rows
        padded = -(-rows // dp) * dp
        if padded != rows:
            out["padded_microbatch_rows"] = padded

        def run(k):
            s = dataclasses.replace(shape, global_batch=padded * k,
                                    microbatches=k)
            progs = build_programs(
                low, s, dp_axes=dp_axes(mesh) if mesh is not None else None,
                mesh=mesh, device="meta")
            return count(progs.step_fn, progs.state_specs(peft_cfg),
                         progs.batch_specs)

        cost = run(m) if m <= 3 else affine(run(2), run(3), m)
        out["counted_microbatches"] = [m] if m <= 3 else [2, 3]
        dev = dataclasses.replace(shape, global_batch=padded // dp * m,
                                  microbatches=m)
    else:
        dev = dataclasses.replace(shape,
                                  global_batch=-(-shape.global_batch // dp))
        progs = build_programs(low, dev, dp_axes=None, device="meta")
        state = progs.state_specs(peft_cfg)
        args = (state.params, state.peft)
        if shape.kind == "decode":
            args += (progs.cache_specs(),)
        cost = count(progs.step_fn, *args, progs.batch_specs)
    out.update(cost=cost, device_shape=dev)
    return out


def _memory(cost: Dict[str, Any]) -> Dict[str, Any]:
    peak = cost["peak_bytes"]
    return {
        "argument_size_in_bytes": cost["argument_bytes"],
        "output_size_in_bytes": cost["output_bytes"],
        "temp_size_in_bytes": peak - cost["argument_bytes"],
        "total_hbm_bytes": peak,
        "fits": peak <= HW["hbm_bytes"],
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               verbose: bool = True, cfg_overrides: Optional[dict] = None,
               shape_overrides: Optional[dict] = None,
               tag: str = "") -> dict:
    """Bill one cell on ``meta``; return the roofline/memory record (the
    JAX record's keys; ``meta_s``, the seconds of its runs on ``meta``,
    in place of ``lower_s``/``compile_s``).  A ``fake`` process group of
    the mesh's size is set up for the cell when there is none.

    ``cfg_overrides`` / ``shape_overrides``: variants of the cell (e.g.
    ``{"attn_backend": "pallas"}``, ``{"seq_len": 512}``)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    peft_cfg = get_peft(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    n_chips = 512 if multi_pod else 256
    t0 = time.monotonic()
    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        cell = cell_cost(cfg, peft_cfg, shape, mesh)
    meta_s = time.monotonic() - t0
    cost = cell["cost"]
    coll = parse_collective_bytes(cost["collectives"])
    terms = roofline_terms(cfg, shape, n_chips, cost, coll,
                           device_shape=cell["device_shape"])
    mem = _memory(cost)
    dev = cell["device_shape"]
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "kind": shape.kind,
        "tag": tag,
        "cfg_overrides": cfg_overrides or {},
        "shape_overrides": shape_overrides or {},
        "meta_s": round(meta_s, 2),
        "device_shape": {"global_batch": dev.global_batch,
                         "seq_len": dev.seq_len,
                         "microbatches": dev.microbatches},
        "counted_microbatches": cell.get("counted_microbatches"),
        "padded_microbatch_rows": cell.get("padded_microbatch_rows"),
        "memory": mem,
        "cost_analysis": {k: cost[k] for k in ("flops", "bytes accessed",
                                              "flops_by_dtype", "ops")},
        "roofline": terms,
    }
    if verbose:
        print(
            f"[dryrun] {arch} {shape_name} mesh={record['mesh']} OK  "
            f"peak/dev={mem['total_hbm_bytes'] / 2 ** 30:.2f}GiB "
            f"fits={mem['fits']}  compute={terms['compute_s']:.4f}s "
            f"memory={terms['memory_s']:.4f}s "
            f"collective={terms['collective_s']:.4f}s "
            f"dominant={terms['dominant']} (meta {meta_s:.1f}s)",
            flush=True,
        )
        print("  cost: flops/dev=%.3e bytes/dev=%.3e collective/dev=%.3e"
              % (terms["hlo_flops_per_device"],
                 terms["hlo_bytes_per_device"],
                 terms["collective_bytes_per_device"]), flush=True)
    return record


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Bill every (arch x shape x mesh) cell of the port's "
                    "step on the meta device against the H100 roofline.")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    for arch in archs:
        valid = {s.name for s in get_shapes(arch)}
        names = ([s.name for s in SHAPES] if args.shape == "all"
                 else [args.shape])
        for shape_name in names:
            if shape_name not in valid:
                print(f"[dryrun] {arch} {shape_name}: SKIP (inapplicable: "
                      f"full attention at 500k)", flush=True)
                continue
            for multi_pod in meshes:
                tag = (f"{arch}__{shape_name}__"
                       f"{'multi' if multi_pod else 'single'}")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] {tag}: cached", flush=True)
                    continue
                try:
                    record = lower_cell(arch, shape_name, multi_pod)
                    with open(path, "w") as f:
                        json.dump(record, f, indent=1)
                except (ValueError, TypeError, KeyError, RuntimeError,
                        OSError) as e:
                    # config errors, a step that cannot run on meta and
                    # write failures mark the cell failed and let the
                    # sweep finish; anything else aborts it
                    failures.append((tag, repr(e)))
                    print(f"[dryrun] {tag}: FAILED {e!r}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}", flush=True)
        return 1
    print("[dryrun] all requested cells billed.", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
