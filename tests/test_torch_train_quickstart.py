"""``examples/torch_quickstart.py`` against ``examples/quickstart.py``: the
same SMOKE weights and QuanTA tensors (carried over from the JAX package
through ``interop``), 40 AdamW steps each; the port's loss curve matches
the JAX quickstart's to 1e-3 relative at every step, and its merged model
matches its adapted model to 1e-3 as the quickstart asserts."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import PeftConfig, attach
from repro.data import SyntheticSeq2Task
from repro.models import build_model
from repro.optim import AdamW
from repro.train import TrainState, make_train_step
from repro_torch import interop

ROOT = Path(__file__).resolve().parent.parent


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_quickstart():
    """``examples/quickstart.py``'s steps 1-3, with the loss of every
    step."""
    cfg = j_get_smoke("llama2-7b-proxy")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    base, peft = attach(jax.random.PRNGKey(1), params,
                        PeftConfig(method="quanta", n_axes=3, scheme=None))
    opt = AdamW(lr=5e-3)
    state = TrainState.create(base, peft, opt)
    step = jax.jit(make_train_step(model, opt))
    data = SyntheticSeq2Task(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=16, task_rank=8)
    losses = []
    for i in range(40):
        batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return base, peft, losses


def test_torch_quickstart_follows_the_jax_quickstart():
    qs = _quickstart()
    base, peft, want = _jax_quickstart()
    model = qs.make_model("cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    tpeft = interop.adapter_set_from_numpy(peft, "cpu")
    state, got = qs.train(model, tbase, tpeft, log=lambda _: None)
    assert len(got) == qs.STEPS == 40
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert qs.merged_vs_adapted(model, state) < 1e-3


def test_torch_quickstart_runs_on_the_cpu(capsys, monkeypatch):
    qs = _quickstart()
    monkeypatch.setattr("sys.argv", ["torch_quickstart.py", "--device",
                                     "cpu"])
    qs.main()
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert "merged-vs-adapted" in out
