"""Every PEFT method trains in the port (the port of
``tests/test_train_loop.py::test_every_method_trains_without_nans``):
3 steps with no NaN on the qwen2-0.5b SMOKE config, with the first step's
loss and grad norm equal to the JAX package's to 1e-4 relative (weights
and adapters carried over through ``interop``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke as j_get_smoke
from repro.core.peft import PeftConfig as JPeftConfig, attach as j_attach
from repro.data import SyntheticSeq2Task as JTask
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro.train import TrainState as JState, make_train_step as j_step
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.data import SyntheticSeq2Task
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.train import TrainState, make_train_step

DATA = dict(vocab_size=256, seq_len=16, global_batch=8, task_rank=4)


@pytest.mark.parametrize("method", ["quanta", "lora", "dora", "dota",
                                    "krona", "ft"])
def test_every_method_trains_and_matches_jax(method):
    jm = j_build_model(j_get_smoke("qwen2-0.5b"))
    params = jm.init(jax.random.PRNGKey(0))
    full_ft = method == "ft"
    if full_ft:
        base, peft = params, {}
    else:
        base, peft = j_attach(jax.random.PRNGKey(1), params, JPeftConfig(
            method=method, scheme=None, n_axes=3))
    jopt = JAdamW(lr=1e-3)
    jstate = JState.create(base, peft, jopt, full_ft=full_ft)
    _, jm_metrics = jax.jit(j_step(jm, jopt, full_ft=full_ft))(
        jstate, {k: jnp.asarray(v) for k, v in JTask(**DATA).batch(0).items()})

    tm = build_model(get_smoke("qwen2-0.5b"), device="cpu")
    tbase = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, base), "cpu")
    tpeft = interop.adapter_set_from_numpy(peft, "cpu") if peft else {}
    opt = AdamW(lr=1e-3)
    state = TrainState.create(tbase, tpeft, opt, full_ft=full_ft)
    step = make_train_step(tm, opt, full_ft=full_ft)
    data = SyntheticSeq2Task(**DATA)
    losses = []
    for i in range(3):
        state, m = step(state, data.batch(i))
        if i == 0:
            np.testing.assert_allclose(
                [float(m["loss"]), float(m["grad_norm"])],
                [float(jm_metrics["loss"]), float(jm_metrics["grad_norm"])],
                rtol=1e-4)
        losses.append(float(m["loss"]))
    assert not np.isnan(losses).any()
    assert losses[-1] < losses[0] * 1.5
