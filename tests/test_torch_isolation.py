"""The port stands alone: it imports neither ``jax`` nor anything of the
JAX package, its entry points refuse to fall back to the CPU on their own,
and CPU tensors never launch a kernel."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_smoke
from repro_torch.core.peft import PeftConfig, attach
from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
from repro_torch.models import build_model
from repro_torch.serve import Request, ServingEngine

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
# the port's examples, imported (not run) with jax blocked
EXAMPLES = [ROOT / "examples" / name for name in (
    "torch_quickstart.py", "torch_serve_batched.py",
    "torch_serve_streaming.py", "torch_finetune_e2e.py",
    "torch_elastic_restart.py")]


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")
    )


# a subprocess prelude in which ``jax``, ``jaxlib`` and the JAX package
# cannot be imported at all
_BLOCK = (
    "import importlib, importlib.abc, sys\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
)


def test_every_module_imports_without_jax():
    code = _BLOCK + (
        f"for name in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "import importlib.util\n"
        f"for i, path in enumerate({[str(p) for p in EXAMPLES]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(_modules()) >= 20


def test_the_blocker_blocks():
    """The prelude above really makes ``jax`` unimportable."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCK + "import jax\n"],
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "blocked: jax" in res.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py",
                          ROOT / "tools" / "kernel_split.py",
                          ROOT / "tools" / "train_probe.py",
                          ROOT / "tools" / "chain_plans.py"] + EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    """Every module of the port (``models/griffin.py``,
    ``models/mamba2.py`` and their configs among them), the card script,
    the tools and the examples."""
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_need_a_device(monkeypatch):
    """With no device given and no card present, the entry points raise
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("llama2-7b-proxy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attach(1, params, PeftConfig(n_axes=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, params, n_slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke("recurrentgemma-2b"))


def test_cpu_path_launches_no_kernel():
    """Nor does Griffin's (its QuanTA on rec_proj and the tail too)."""
    from repro_torch.configs import get_peft

    for arch in ("llama2-7b-proxy", "recurrentgemma-2b"):
        cfg = get_smoke(arch).replace(attn_backend="pallas",
                                      peft_backend="pallas")
        model = build_model(cfg, device="cpu")
        peft_cfg = get_peft(arch)
        base, peft = attach(1, model.init(0), PeftConfig(
            n_axes=peft_cfg.n_axes, targets=peft_cfg.targets), device="cpu")
        reset_launch_counts()
        eng = ServingEngine(model, base, peft, n_slots=2, max_len=32,
                            device="cpu")
        for i in range(3):
            eng.submit(Request(uid=i, prompt=[1 + i, 2, 3],
                               max_new_tokens=4))
        eng.run()
        assert eng.stats["decode_calls"] > 0
        assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_cuda_tensors_never_take_the_plain_version():
    """The wrappers route by device: a tensor on a device they have no
    kernel for raises instead of silently running the plain version."""
    from repro_torch.kernels.dispatch import route

    assert route(torch.zeros(1)) == "plain"
    with pytest.raises(ValueError):
        route(torch.zeros(1, device="meta"))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_repo(alone, tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result without a
    card, and likewise when it stands in a directory without the port."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("name", [
    "repro_torch.core.bank", "repro_torch.core.baselines",
    "repro_torch.kernels.banked_gather", "repro_torch.serve.adapter_pool",
    "repro_torch.serve.metrics",
    "repro_torch.optim.adamw", "repro_torch.optim.schedules",
    "repro_torch.optim.compress", "repro_torch.data.pipeline",
    "repro_torch.data.tokenizer", "repro_torch.train.loop",
])
def test_bank_modules_are_covered(name):
    """The multi-tenant and training modules are among those imported with
    ``jax`` and the JAX package blocked, and among the files whose imports
    are read."""
    _covered(name)


@pytest.mark.parametrize("name", [
    "repro_torch.analysis", "repro_torch.analysis.sanitize",
    "repro_torch.serve.scheduler", "repro_torch.serve.frontend",
    "repro_torch.serve.engine", "repro_torch.models.attention",
    "repro_torch.models.moe", "repro_torch.models.transformer",
])
def test_serving_modules_are_covered(name):
    """The capture guard, the scheduler, the front end and the modules
    the graph tick runs through (the MoE FFN among them) are among those
    imported with ``jax`` and the JAX package blocked, and among the
    files whose imports are read."""
    _covered(name)


@pytest.mark.parametrize("name", [
    "repro_torch.checkpoint", "repro_torch.checkpoint.store",
    "repro_torch.train.elastic", "repro_torch.configs.shapes",
    "repro_torch.models.api",
])
def test_checkpoint_modules_are_covered(name):
    """The checkpoint store, the elastic control plane, the shape grid
    and the meta-device specs are among the modules imported with
    ``jax`` and the JAX package blocked, and among the files whose
    imports are read."""
    _covered(name)


@pytest.mark.parametrize("name", [
    "repro_torch.configs", "repro_torch.configs.llama2_7b_proxy",
    "repro_torch.configs.qwen2_0_5b", "repro_torch.configs.yi_6b",
    "repro_torch.configs.phi3_medium_14b", "repro_torch.configs.minicpm_2b",
    "repro_torch.configs.mixtral_8x7b",
    "repro_torch.configs.llama4_maverick_400b_a17b",
])
def test_config_modules_are_covered(name):
    """The config registry, its five dense and two MoE configs are among
    the modules imported with ``jax`` and the JAX package blocked, and
    among the files whose imports are read."""
    _covered(name)


def test_examples_are_covered():
    """The torch serving examples exist, are read for imports and are
    imported with ``jax`` blocked."""
    for path in EXAMPLES:
        assert path.is_file()
        assert not {n.split(".")[0] for n in _imports(path)} & {
            "jax", "jaxlib", "repro"}


def _covered(name):
    assert name in _modules()
    path = PKG.joinpath(*name.split(".")[1:])
    path = (path / "__init__.py" if path.is_dir()
            else path.with_suffix(".py"))
    assert path in set(PKG.rglob("*.py"))
    assert not {n.split(".")[0] for n in _imports(path)} & {
        "jax", "jaxlib", "repro"}


def test_cpu_train_step_launches_no_kernel():
    """A train step on the CPU under the flash backend runs kernel 3's
    Function on its plain version, and no counter moves."""
    from repro_torch.data import SyntheticSeq2Task
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, make_train_step

    cfg = get_smoke("llama2-7b-proxy").replace(attn_backend="pallas")
    model = build_model(cfg, device="cpu")
    base, peft = attach(1, model.init(0), PeftConfig(n_axes=4), device="cpu")
    opt = AdamW(lr=5e-3)
    reset_launch_counts()
    step = make_train_step(model, opt)
    state, metrics = step(TrainState.create(base, peft, opt),
                          SyntheticSeq2Task(256, 16, 4, 4).batch(0))
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_cpu_bank_path_launches_no_kernel():
    """A bank engine on the CPU under the kernel backend takes the plain
    versions: LoRA through the banked-gather wrappers, QuanTA through the
    chain wrappers, and no counter moves."""
    from repro_torch.core.bank import AdapterBank

    cfg = get_smoke("llama2-7b-proxy").replace(attn_backend="pallas",
                                               peft_backend="pallas")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    _, lora = attach(2, params, PeftConfig(method="lora", rank=4),
                     device="cpu")
    bank = AdapterBank.build(params, {
        "q": attach(1, params, PeftConfig(n_axes=4), device="cpu"),
        "l": lora})
    reset_launch_counts()
    eng = ServingEngine(model, params, adapters=bank, n_slots=2, max_len=32,
                        device="cpu")
    for i, name in enumerate(("q", "l", None)):
        eng.submit(Request(uid=i, prompt=[1 + i, 2, 3], max_new_tokens=4),
                   adapter=name)
    eng.run()
    assert eng.stats["decode_calls"] > 0
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_cpu_foldfree_bank_path_launches_no_kernel():
    """Fold-free QuanTA tenants in a bank on the CPU under the kernel
    backend: their banked delta takes the chain wrapper's plain version,
    and no counter moves."""
    from repro_torch.core.bank import AdapterBank

    cfg = get_smoke("llama2-7b-proxy").replace(attn_backend="pallas",
                                               peft_backend="pallas")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    bank = AdapterBank.build(params, {
        f"f{i}": attach(1 + i, params, PeftConfig(n_axes=4, fold=False),
                        device="cpu")[1] for i in range(2)})
    reset_launch_counts()
    eng = ServingEngine(model, params, adapters=bank, n_slots=2, max_len=32,
                        device="cpu")
    for i, name in enumerate(("f0", "f1", None)):
        eng.submit(Request(uid=i, prompt=[1 + i, 2, 3], max_new_tokens=4),
                   adapter=name)
    eng.run()
    assert eng.stats["decode_calls"] > 0
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
