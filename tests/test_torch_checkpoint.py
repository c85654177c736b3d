"""The port's checkpoint store against the JAX package's on the same
states and files: the SMOKE llama2-7b-proxy ``TrainState`` (QuanTA on
q/v, 3 axes, folded and fold-free, f32 and bf16 params, int8 compression
on so that ``ef_state`` is present, its leaves given seeded values) saved
by both packages gives equal manifests and byte-equal leaf files; a
checkpoint of either restores in the other bit for bit (the port onto a
``meta`` template from ``param_specs``, ``attach`` and
``TrainState.create``; JAX onto ``jax.eval_shape``); both refuse the same
faults with the same exceptions; a run saved at step 3 and resumed equals
the uninterrupted run bit for bit, and JAX's at 1e-4."""

import dataclasses
import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import (
    AsyncCheckpointer as JAsyncCheckpointer, latest_step as j_latest_step,
    restore as j_restore, save as j_save,
)
from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.data import SyntheticSeq2Task as JTask
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro.train import TrainState as JState, make_train_step as j_step
from repro_torch import interop
from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_step, restore, restore_resharded, save,
    tree_flatten_with_paths,
)
from repro_torch.configs import get_smoke
from repro_torch.core.peft import PeftConfig, attach
from repro_torch.data import SyntheticSeq2Task
from repro_torch.models import build_model, param_specs
from repro_torch.optim import AdamW
from repro_torch.train import TrainState, make_train_step

ARCH = "llama2-7b-proxy"
STEP = 7
CASES = [(fold, dtype) for fold in (True, False)
         for dtype in ("float32", "bfloat16")]
CASE_IDS = [f"{'folded' if f else 'foldfree'}-{d}" for f, d in CASES]
RTOL = 1e-4           # the port's training tolerance against JAX


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The SMOKE steps here are tiny: one intra-op thread runs them
    fastest, and keeps them quick beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_state(fold, dtype, compress=True):
    """A JAX ``TrainState`` some steps in: every leaf but the step
    counters drawn from a seeded normal, in its own dtype."""
    cfg = j_get_smoke(ARCH).replace(param_dtype=getattr(jnp, dtype))
    params = j_build_model(cfg).init(jax.random.PRNGKey(0))
    base, peft = j_attach(jax.random.PRNGKey(1), params, JPeftConfig(
        method="quanta", n_axes=3, fold=fold))
    state = JState.create(base, peft, JAdamW(lr=1e-3), compress=compress)
    rng = np.random.default_rng(0)
    state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape, np.float32)
                              ).astype(x.dtype), state)
    return dataclasses.replace(
        state, step=jnp.int32(STEP),
        opt_state=dataclasses.replace(state.opt_state, step=jnp.int32(STEP)))


def _torch_state(fold, dtype):
    js = _jax_state(fold, dtype)
    return interop.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), "cpu")


def _template(fold, dtype, compress=True):
    """The port's ``jax.eval_shape``: the state's structure on ``meta``."""
    cfg = get_smoke(ARCH).replace(param_dtype=getattr(torch, dtype))
    base, peft = attach(1, param_specs(cfg), PeftConfig(
        method="quanta", n_axes=3, fold=fold), device="meta")
    return TrainState.create(base, peft, AdamW(lr=1e-3), compress=compress)


def _bits(x) -> np.ndarray:
    """A leaf's stored bits: bf16 as uint16, ints as int32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp) for kp, _ in flat]
    return paths, [v for _, v in flat]


def _assert_bits_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_paths_follow_the_jax_flattening():
    """The flattener's paths and order are ``tree_flatten_with_path``'s,
    the two step counters among them as ints."""
    js = _jax_state(False, "float32")
    jpaths, _ = _jax_leaves(js)
    paths, leaves = tree_flatten_with_paths(_torch_state(False, "float32"))
    assert paths == jpaths
    assert ".step" in paths and ".opt_state/.step" in paths
    assert ".peft/.tree/layers/attn/q_proj/.tensors/0" in paths
    assert leaves[paths.index(".step")] == STEP
    # the meta template has the same leaves
    assert tree_flatten_with_paths(_template(False, "float32"))[0] == paths


@pytest.mark.parametrize("fold,dtype", CASES, ids=CASE_IDS)
def test_same_manifest_and_leaf_files(fold, dtype, tmp_path):
    jdir = j_save(str(tmp_path / "jax"), STEP, _jax_state(fold, dtype))
    tdir = save(str(tmp_path / "torch"), STEP, _torch_state(fold, dtype))
    with open(os.path.join(jdir, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        tman = json.load(f)
    assert tman == jman
    assert any(e["dtype"] == "bfloat16" for e in tman["leaves"]) == (
        dtype == "bfloat16")
    for entry in jman["leaves"]:
        with open(os.path.join(jdir, entry["file"]), "rb") as f:
            want = f.read()
        with open(os.path.join(tdir, entry["file"]), "rb") as f:
            assert f.read() == want, entry["path"]


@pytest.mark.parametrize("fold,dtype", CASES, ids=CASE_IDS)
def test_jax_checkpoint_restores_in_the_port(fold, dtype, tmp_path):
    js = _jax_state(fold, dtype)
    j_save(str(tmp_path), STEP, js)
    got = restore(str(tmp_path), STEP, _template(fold, dtype), device="cpu")
    assert type(got.step) is int and got.step == STEP
    assert type(got.opt_state.step) is int and got.opt_state.step == STEP
    jpaths, jleaves = _jax_leaves(js)
    paths, leaves = tree_flatten_with_paths(got)
    assert paths == jpaths
    _assert_bits_equal(leaves, jleaves)
    assert all(t.device.type == "cpu" for t in leaves
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("fold,dtype", CASES, ids=CASE_IDS)
def test_port_checkpoint_restores_in_jax(fold, dtype, tmp_path):
    ts = _torch_state(fold, dtype)
    save(str(tmp_path), STEP, ts)
    template = jax.eval_shape(lambda: _jax_state(fold, dtype))
    got = j_restore(str(tmp_path), STEP, template)
    assert got.step.dtype == np.int32 and int(got.step) == STEP
    assert got.opt_state.step.dtype == np.int32
    _assert_bits_equal(_jax_leaves(got)[1], tree_flatten_with_paths(ts)[1])


# ------------------------------------------------------------- refusals

def _pkg(name):
    """One package's store and a two-leaf tree of it ({"b": {"c": bf16},
    "w": f32 8 x 8}, filled with ``v``)."""
    if name == "jax":
        return SimpleNamespace(
            save=j_save, latest_step=j_latest_step, Async=JAsyncCheckpointer,
            restore=lambda d, s, t: j_restore(d, s, t),
            tree=lambda v: {"w": jnp.full((8, 8), v, jnp.float32),
                            "b": {"c": jnp.full((4,), v, jnp.bfloat16)}},
            bigger=lambda: {"w": jnp.zeros((8, 8)), "x": jnp.zeros(2),
                            "b": {"c": jnp.zeros(4, jnp.bfloat16)}})
    return SimpleNamespace(
        save=save, latest_step=latest_step, Async=AsyncCheckpointer,
        restore=lambda d, s, t: restore(d, s, t, device="cpu"),
        tree=lambda v: {"w": torch.full((8, 8), float(v)),
                        "b": {"c": torch.full((4,), float(v),
                                              dtype=torch.bfloat16)}},
        bigger=lambda: {"w": torch.zeros(8, 8), "x": torch.zeros(2),
                        "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}})


def _corrupt(p, d):
    path = p.save(d, 1, p.tree(1.0))
    with open(os.path.join(path, "leaf_00001.npy"), "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef")
    p.restore(d, 1, p.tree(0.0))


def _count(p, d):
    p.save(d, 1, p.tree(1.0))
    p.restore(d, 1, p.bigger())


def _stale_tmp(p, d):
    os.makedirs(os.path.join(d, "step_000000000009.tmp_123"))
    with open(os.path.join(d, "step_000000000009.tmp_123", "manifest.json"),
              "w") as f:
        f.write("{}")
    before = p.latest_step(d)
    p.save(d, 2, p.tree(2.0))
    return before, sorted(os.listdir(d)), p.latest_step(d)


def _no_manifest(p, d):
    p.save(d, 3, p.tree(3.0))
    os.makedirs(os.path.join(d, "step_000000000008"))
    os.makedirs(os.path.join(d, "step_000000000009.tmp_7"))
    os.makedirs(os.path.join(d, "other"))
    return p.latest_step(d), p.latest_step(os.path.join(d, "missing"))


def _gc(p, d):
    ck = p.Async(d, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, p.tree(float(s)))
    ck.close()
    out = p.restore(d, 4, p.tree(0.0))
    return (sorted(os.listdir(d)),
            [_bits(x).tolist() for x in (out["b"]["c"], out["w"])])


SCENARIOS = {"corrupted leaf": _corrupt, "leaf count": _count,
             "stale tmp": _stale_tmp, "latest ignores": _no_manifest,
             "gc keep": _gc}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_both_packages_refuse_and_keep_alike(scenario, tmp_path):
    """Each scenario in a fresh directory per package: the same exception
    type and message, or the same result."""
    outcomes = {}
    for name in ("jax", "torch"):
        d = str(tmp_path / name)
        os.makedirs(d)
        try:
            outcomes[name] = ("ok", SCENARIOS[scenario](_pkg(name), d))
        except Exception as e:                        # noqa: BLE001
            outcomes[name] = (type(e), str(e))
    assert outcomes["torch"] == outcomes["jax"]
    want = {"corrupted leaf": OSError, "leaf count": ValueError}
    if scenario in want:
        assert issubclass(outcomes["torch"][0], want[scenario])
    if scenario == "stale tmp":
        assert outcomes["torch"][1] == (None, ["step_000000000002"], 2)
    if scenario == "latest ignores":
        assert outcomes["torch"][1] == (3, None)


def test_async_save_is_a_snapshot(tmp_path):
    """Changing the tensors in place right after ``save`` returns leaves
    the written checkpoint as it was at the call."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"w": w, "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, tree)
    w.mul_(-1.0)
    tree["b"]["c"].zero_()
    ck.close()
    out = restore(str(tmp_path), 1, {"w": torch.empty(8, 8, device="meta"),
                                     "b": {"c": torch.empty(
                                         4, dtype=torch.bfloat16,
                                         device="meta")}}, device="cpu")
    assert torch.equal(out["w"], torch.arange(64.0).reshape(8, 8))
    assert torch.equal(out["b"]["c"], torch.ones(4, dtype=torch.bfloat16))


def test_restore_resharded_onto_one_device_and_refuses_a_mesh(tmp_path):
    ts = _torch_state(True, "bfloat16")
    save(str(tmp_path), STEP, ts)
    template = _template(True, "bfloat16")
    got = restore_resharded(str(tmp_path), STEP, template,
                            torch.device("cpu"))
    leaves = tree_flatten_with_paths(got)[1]
    _assert_bits_equal(leaves, tree_flatten_with_paths(ts)[1])
    assert all(t.device.type == "cpu" for t in leaves
               if isinstance(t, torch.Tensor))
    # a placement is a device, or a DeviceMesh with a spec tree (held on
    # gloo ranks in tests/test_torch_mesh.py); anything else raises
    from repro_torch.launch import make_abstract_mesh

    for placement in ({"w": "cpu"}, ("data", "model"), object(),
                      make_abstract_mesh((2, 1), ("data", "model"))):
        with pytest.raises(TypeError, match="DeviceMesh with a spec"):
            restore_resharded(str(tmp_path), STEP, template, placement)


def test_restore_onto_meta_defaults_to_the_card(tmp_path, monkeypatch):
    """A ``meta`` template with no device goes to the card: without one
    it raises, never falling back to the CPU; a CPU template stays on
    the CPU."""
    save(str(tmp_path), 1, {"w": torch.ones(3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(str(tmp_path), 1, {"w": torch.empty(3, device="meta")})
    out = restore(str(tmp_path), 1, {"w": torch.zeros(3)})
    assert out["w"].device.type == "cpu" and torch.equal(out["w"],
                                                         torch.ones(3))


# --------------------------------------------------------------- resume

def _data():
    kw = dict(vocab_size=256, seq_len=32, global_batch=16, task_rank=8)
    return JTask(**kw), SyntheticSeq2Task(**kw)


@functools.lru_cache(maxsize=None)
def _jax_run(steps=6):
    cfg = j_get_smoke(ARCH)
    jm = j_build_model(cfg)
    base, peft = j_attach(jax.random.PRNGKey(1),
                          jm.init(jax.random.PRNGKey(0)),
                          JPeftConfig(method="quanta", n_axes=3))
    opt = JAdamW(lr=5e-3)
    state = JState.create(base, peft, opt)
    step = jax.jit(j_step(jm, opt, microbatches=2))
    data, _ = _data()
    losses = []
    for i in range(steps):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data.batch(i).items()})
        losses.append(float(m["loss"]))
    init = jax.tree_util.tree_map(np.asarray, (base, peft))
    return init, losses


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """6 steps (microbatches 2) against 3, an async save, a restore onto
    the ``meta`` template at ``latest_step`` and 3 more: losses and every
    leaf at step 6 equal bit for bit, and the losses JAX's at 1e-4."""
    (jbase, jpeft), want = _jax_run()
    model = build_model(get_smoke(ARCH), device="cpu")
    base = interop.params_from_numpy(jbase, "cpu")
    peft = interop.adapter_set_from_numpy(jpeft, "cpu")
    opt = AdamW(lr=5e-3)
    step = make_train_step(model, opt, microbatches=2)
    _, data = _data()

    def run(state, first, last):
        losses = []
        for i in range(first, last):
            state, m = step(state, data.batch(i))
            losses.append(float(m["loss"]))
        return state, losses

    full, full_losses = run(TrainState.create(base, peft, opt), 0, 6)
    half, losses = run(TrainState.create(base, peft, opt), 0, 3)
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(half.step, half)
    ck.close()
    start = latest_step(str(tmp_path))
    assert start == 3
    cfg = get_smoke(ARCH)
    tbase, tpeft = attach(1, param_specs(cfg), PeftConfig(
        method="quanta", n_axes=3), device="meta")
    template = TrainState.create(tbase, tpeft, opt)
    back = restore(str(tmp_path), start, template, device="cpu")
    _assert_bits_equal(tree_flatten_with_paths(back)[1],
                       tree_flatten_with_paths(half)[1])
    resumed, rest = run(back, start, 6)
    assert losses + rest == full_losses
    assert resumed.step == full.step == 6
    _assert_bits_equal(tree_flatten_with_paths(resumed)[1],
                       tree_flatten_with_paths(full)[1])
    np.testing.assert_allclose(full_losses, want, rtol=RTOL)


# -------------------------------------------------------------- examples

def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_elastic_restart_example_on_the_cpu(capsys):
    """The elastic example end to end: the resumed run ends with the
    original run's loss (it asserts rtol 1e-5; here bit for bit)."""
    before, after = _example("torch_elastic_restart.py").main(
        ["--device", "cpu"])
    assert before == after
    assert "restore_step=20" in capsys.readouterr().out


def test_finetune_example_saves_and_resumes(tmp_path):
    """20 steps with checkpoints (keep 2), then ``--resume`` to 30 from
    the newest one onto the meta template: the resumed run starts at
    step 20 and leaves checkpoints 20 and 30, and checkpoint 30 restores
    onto the example's meta template equal to its final state, leaf for
    leaf."""
    ex = _example("torch_finetune_e2e.py")
    d = str(tmp_path)
    ex.main(["--device", "cpu", "--steps", "20", "--ckpt-dir", d])
    assert latest_step(d) == 20
    state, acc = ex.main(["--device", "cpu", "--steps", "30", "--ckpt-dir",
                          d, "--resume"])
    assert state.step == 30 and 0.0 <= acc <= 1.0
    assert sorted(os.listdir(d)) == ["step_000000000020",
                                     "step_000000000030"]
    back = restore(d, 30, ex.meta_template(ex.SMALL, AdamW(lr=1e-3)),
                   device="cpu")
    _assert_bits_equal(tree_flatten_with_paths(back)[1],
                       tree_flatten_with_paths(state)[1])
