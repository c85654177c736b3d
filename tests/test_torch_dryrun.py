"""The port's dry run (``launch/op_cost.py``, ``launch/dryrun.py``) on the
``meta`` device against the JAX program's HLO on the CPU.

* prefill and decode: the op counter's dot FLOPs of the port's step equal
  ``repro.launch.hlo_cost.hlo_cost`` of the JAX step (jitted on one CPU
  device) on every arch's SMOKE config (4 x 64, QuanTA at 3 axes);
* train (qwen2-0.5b, mixtral-8x7b, recurrentgemma-2b, mamba2-1.3b): equal
  up to the named term.  JAX scans the layers, and a scan's transpose
  runs the same body at every trip: it computes the first layer's input
  cotangent (the dX of its frozen projections, the attention's dK),
  which nothing reads, since the embedding is frozen; PyTorch's autograd
  prunes it.  The term is measured on the port: the step with the
  embedding's output asked for its gradient, less the step.  XLA unrolls
  a scan of one trip and then prunes it too (recurrentgemma's SMOKE
  config: one macro block), so there the programs are equal.  mamba2
  has a second term, the other way: ``torch.utils.checkpoint``'s
  recompute runs a layer up to its adapted out_proj's delta, its base
  product included, which XLA drops as unread;
* the microbatch count extrapolated from 2 and 3 microbatches equals the
  direct count; under a fake ``(4, 1)`` mesh a train cell's device bills
  a quarter of the one-device step's FLOPs and ``all_reduce``s 4 x
  (trainable elements + 1) bytes; the fake group is gone afterwards,
  and importing ``dryrun`` sets up none;
* ``lower_cell`` on a FULL cell returns the JAX record's keys;
* the counter's conventions: bytes of views, slice writes and gathers,
  the live peak through autograd's saved tensors, collectives by kind,
  and a kernel launch while counting raises.
"""

import ast
import functools
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_peft as j_get_peft, get_smoke as j_get_smoke
from repro.launch.hlo_cost import hlo_cost
from repro.launch.steps import build_programs as j_build_programs
from repro.models.common import ShapeConfig as JShape
from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config, get_peft, get_smoke
from repro_torch.core.adapters import tree_leaves
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_programs
from repro_torch.models.common import ShapeConfig

ROOT = Path(__file__).resolve().parent.parent
TRAIN_ARCHS = ("qwen2-0.5b", "mixtral-8x7b", "recurrentgemma-2b",
               "mamba2-1.3b")


def _peft(get, arch):
    # the JAX mini dry run's PEFT
    return get(arch).replace(scheme=None, n_axes=3)


@functools.lru_cache(maxsize=None)
def _jax_flops(arch, kind):
    cfg = j_get_smoke(arch)
    shape = JShape("t", seq_len=64, global_batch=4, kind=kind)
    progs = j_build_programs(cfg, shape, dp_axes=None)
    specs = progs.state_specs(_peft(j_get_peft, arch))
    if kind == "train":
        args = (specs, progs.batch_specs)
    elif kind == "prefill":
        args = (specs.params, specs.peft, progs.batch_specs)
    else:
        args = (specs.params, specs.peft, progs.cache_specs(),
                progs.batch_specs)
    text = jax.jit(progs.step_fn).lower(*args).compile().as_text()
    return hlo_cost(text)["flops"]


def _programs(arch, kind):
    shape = ShapeConfig("t", seq_len=64, global_batch=4, kind=kind)
    progs = build_programs(get_smoke(arch), shape, dp_axes=None,
                           device="meta")
    return progs, progs.state_specs(_peft(get_peft, arch))


def _port_flops(arch, kind):
    progs, state = _programs(arch, kind)
    if kind == "train":
        args = (state, progs.batch_specs)
    elif kind == "prefill":
        args = (state.params, state.peft, progs.batch_specs)
    else:
        args = (state.params, state.peft, progs.cache_specs(),
                progs.batch_specs)
    return op_cost.count(progs.step_fn, *args)["flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_flops_equal_the_jax_hlo(arch, kind):
    assert _port_flops(arch, kind) == _jax_flops(arch, kind)


def _first_layer_cotangent(arch, monkeypatch):
    """The port's step with the embedding's output asked for its
    gradient, less the step: the first layer's input cotangent."""
    progs, state = _programs(arch, "train")
    base = op_cost.count(progs.step_fn, state,
                         progs.batch_specs)["flops"]
    asked = []
    embed, grad = progs.model._embed, torch.autograd.grad

    def embed_asked(*a, **k):
        asked.append(embed(*a, **k).requires_grad_(True))
        return asked[-1]

    def grad_too(out, inputs, **kw):
        got = grad(out, list(inputs) + asked, **kw)
        asked.clear()
        return got[:len(inputs)]

    monkeypatch.setattr(progs.model, "_embed", embed_asked)
    monkeypatch.setattr(torch.autograd, "grad", grad_too)
    with_x = op_cost.count(progs.step_fn, state, progs.batch_specs)["flops"]
    monkeypatch.undo()
    return base, with_x - base


def _jax_scans_first_layer(cfg):
    """JAX's layer scan has two trips or more (one trip is unrolled)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_period >= 2
    return cfg.n_layers >= 2


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_flops_equal_the_jax_hlo_up_to_the_named_term(
        arch, monkeypatch):
    cfg = get_smoke(arch)
    port, cotangent = _first_layer_cotangent(arch, monkeypatch)
    assert cotangent > 0
    term = cotangent if _jax_scans_first_layer(cfg) else 0
    recompute = 0
    if cfg.family == "ssm":
        # out_proj's base product (d_inner -> d) a layer, rerun by the
        # checkpoint's recompute on the way to its delta
        tokens = 4 * 64
        recompute = (cfg.n_layers * 2 * tokens * cfg.ssm_expand
                     * cfg.d_model * cfg.d_model)
    assert _jax_flops(arch, "train") == port + term - recompute
    assert term > 0 or cfg.family == "hybrid"


@pytest.fixture
def fake_mesh():
    """A ``(4, 1)`` mesh over a fake world of 4 ranks (this process rank
    0), torn down after the test."""
    assert not dist.is_initialized()
    with dryrun.fake_world(4):
        yield make_host_mesh(4, 1, device="cpu")
    assert not dist.is_initialized()


def _train_counts(cfg, peft_cfg, rows, m, mesh):
    shape = ShapeConfig("t", seq_len=32, global_batch=rows * m,
                        kind="train", microbatches=m)
    progs = build_programs(dryrun._reference(cfg), shape,
                           dp_axes=("data",), mesh=mesh, device="meta")
    state = progs.state_specs(peft_cfg)
    return op_cost.count(progs.step_fn, state, progs.batch_specs), state


def test_affine_microbatch_count_equals_the_direct_count(fake_mesh):
    cfg, peft_cfg = get_smoke("qwen2-0.5b"), _peft(get_peft, "qwen2-0.5b")
    direct, _ = _train_counts(cfg, peft_cfg, 8, 5, fake_mesh)
    shape = ShapeConfig("t", seq_len=32, global_batch=40, kind="train",
                        microbatches=5)
    cell = dryrun.cell_cost(cfg, peft_cfg, shape, fake_mesh)
    got = cell["cost"]
    assert cell["counted_microbatches"] == [2, 3]
    for key in ("flops", "flops_by_dtype", "bytes accessed", "collectives",
                "peak_bytes", "argument_bytes"):
        assert got[key] == direct[key], key
    assert direct["collectives"]["all-reduce"] > 0


def test_fake_mesh_bills_a_quarter_and_the_gradient_all_reduce(fake_mesh):
    cfg, peft_cfg = get_smoke("qwen2-0.5b"), _peft(get_peft, "qwen2-0.5b")
    shape = ShapeConfig("t", seq_len=32, global_batch=16, kind="train",
                        microbatches=2)
    dp = dryrun.cell_cost(cfg, peft_cfg, shape, fake_mesh)
    one = dryrun.cell_cost(cfg, peft_cfg, shape, None)
    assert dp["device_shape"].global_batch == 4
    assert one["device_shape"].global_batch == 16
    assert 4 * dp["cost"]["flops"] == one["cost"]["flops"]
    _, state = _train_counts(cfg, peft_cfg, 8, 2, fake_mesh)
    trainable = sum(t.numel() for t in tree_leaves(state.peft))
    assert dp["cost"]["collectives"] == {
        "all-gather": 0, "all-reduce": 4 * (trainable + 1),
        "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    assert sum(one["cost"]["collectives"].values()) == 0


def test_importing_dryrun_sets_up_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun\n"
            "assert not dist.is_initialized()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


def _jax_record_keys():
    """The keys of the record ``repro/launch/dryrun.py`` ``lower_cell``
    writes (its ``record = {...}`` literal)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record literal in repro/launch/dryrun.py")


def test_lower_cell_on_a_full_cell_returns_the_jax_record_keys():
    assert not dist.is_initialized()
    rec = dryrun.lower_cell("qwen2-0.5b", "decode_32k", False,
                            verbose=False)
    assert not dist.is_initialized()
    # no XLA: the meta run's seconds stand for lowering and compiling
    want = _jax_record_keys() - {"lower_s", "compile_s",
                                 "xla_cost_analysis_raw"}
    assert want <= set(rec) and "meta_s" in rec
    cfg = get_config("qwen2-0.5b")
    assert rec["n_chips"] == 256 and rec["mesh"] == "16x16"
    # this data rank's 128 / 16 slots, at the whole cache length
    assert rec["device_shape"] == {"global_batch": 8, "seq_len": 32768,
                                   "microbatches": 1}
    cache = 2 * cfg.n_layers * 8 * 32768 * cfg.kv_dim * 2
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > cache and mem["fits"]
    roof = rec["roofline"]
    assert roof["hlo_flops"] == 256 * roof["hlo_flops_per_device"]
    assert roof["step_time_bound_s"] == roof["memory_s"] > 0
    assert sum(roof["collective_breakdown"].values()) == 0


# ------------------------------------------------------ the counter itself
def test_counter_bytes_flops_and_live_peak():
    a = torch.empty(64, 32, device="meta")
    w = torch.empty(32, 16, device="meta", dtype=torch.bfloat16)
    got = op_cost.count(lambda a, w: (a.to(w.dtype) @ w).relu(), a, w)
    assert got["flops_by_dtype"] == {"torch.bfloat16": 2 * 64 * 32 * 16}
    cast, mm, relu = 64 * 32 * (4 + 2), 64 * 32 * 2 + 32 * 16 * 2 + \
        64 * 16 * 2, 2 * 64 * 16 * 2
    assert got["bytes accessed"] == cast + mm + relu
    assert got["argument_bytes"] == 64 * 32 * 4 + 32 * 16 * 2
    # at the product: args, the cast and the product (the cast dies
    # before the relu)
    assert got["peak_bytes"] == got["argument_bytes"] + 64 * 32 * 2 + \
        64 * 16 * 2
    assert got["output_bytes"] == 64 * 16 * 2

    cache = torch.zeros(16, 8, device="meta")
    row = torch.empty(8, device="meta")
    idx = torch.tensor([3], device="meta")

    def writes(cache, row, idx):
        cache[2].copy_(row)                       # a slice write
        cache.index_put_((idx,), row[None])
        return cache.view(8, 16).t()[idx]         # views, then a gather

    got = op_cost.count(writes, cache, row, idx)
    # the row twice; the row and the index twice; a (1, 8) row gathered
    # twice and the index
    assert got["bytes accessed"] == (2 * 32 + 2 * (32 + 8)
                                     + 2 * 32 + 8)
    assert got["flops"] == 0


def test_counter_live_peak_keeps_saved_tensors():
    x = torch.empty(1024, device="meta", requires_grad=True)

    def step(x):
        y = x.exp()                 # saved for the backward
        z = (y * 2).sum()
        del y
        return torch.autograd.grad(z, [x])[0]

    got = op_cost.count(step, x)
    # x, y (held by autograd after ``del``), y * 2: 3 x 4 KiB at once
    assert got["peak_bytes"] >= 3 * 4096


def test_counter_collectives_by_kind(fake_mesh):
    group = fake_mesh.get_group("data")
    t = torch.empty(10, 3, device="meta")
    out = torch.empty(40, 3, device="meta")
    got = op_cost.count(lambda t, out: (
        dist.all_reduce(t, group=group),
        dist.all_gather_into_tensor(out, t, group=group)), t, out)
    assert got["collectives"]["all-reduce"] == 120
    assert got["collectives"]["all-gather"] == 480


def test_counter_refuses_a_kernel_launch(monkeypatch):
    counts = dict(kernels.launch_counts())
    calls = iter([counts, dict(counts, flash_attention=1)])
    monkeypatch.setattr(kernels, "launch_counts", lambda: next(calls))
    with pytest.raises(RuntimeError, match="flash_attention"):
        op_cost.count(lambda: None)


def test_fake_world_needs_the_fake_backend(monkeypatch):
    monkeypatch.setattr(dist.Backend, "backend_list",
                        [b for b in dist.Backend.backend_list
                         if b != "fake"])
    with pytest.raises(RuntimeError, match="'fake' backend"):
        with dryrun.fake_world(4):
            pass
    assert not dist.is_initialized()
