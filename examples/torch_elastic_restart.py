"""Elastic failure recovery on the PyTorch port: checkpoint -> lose hosts
-> re-plan -> restore -> resume.

    PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]

The same steps as ``examples/elastic_restart.py`` on the JAX package:
training goes on with async checkpoints (one at step 20); a "host
failure" event gives a recovery plan (a smaller mesh, the checkpoint
step, the new data-shard count); training resumes from the checkpoint,
restored onto a ``meta``-device template and placed on this process's
one device (``restore_resharded``, which also takes a ``DeviceMesh``
and a spec tree), with the deterministic data pipeline replaying the same global
token stream, and ends with the loss of the original run.  Runs on the
card by default (the attention through the flash kernel and its
recompute backward); ``--device cpu`` runs the plain versions.
"""

import argparse
import tempfile

import numpy as np

from repro_torch.checkpoint import AsyncCheckpointer, restore_resharded
from repro_torch.configs import get_smoke
from repro_torch.core.peft import PeftConfig, attach
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, param_specs
from repro_torch.optim import AdamW
from repro_torch.train import ElasticController, TrainState, make_train_step

PEFT = PeftConfig(method="quanta", n_axes=3, scheme=None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)

    cfg = get_smoke("llama2-7b-proxy").replace(attn_backend="pallas")
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    base, peft = attach(1, params, PEFT, device=model.device)
    opt = AdamW(lr=1e-3)
    state = TrainState.create(base, peft, opt)
    step_fn = make_train_step(model, opt)

    ckpt_dir = tempfile.mkdtemp(prefix="quanta_torch_elastic_")
    ckpt = AsyncCheckpointer(ckpt_dir)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32,
                       global_batch=16, seed=7)

    for i in range(30):
        state, m = step_fn(state, data.batch(i))
        if i == 19:
            ckpt.save(20, state)
    ckpt.wait()
    loss_before = float(m["loss"])
    print(f"trained to step 30 (ckpt at 20), loss={loss_before:.4f} "
          f"({model.device})")

    # ---- failure event: 2 of 8 hosts lost --------------------------------
    ctl = ElasticController(
        hosts=[f"host{i}" for i in range(8)], devices_per_host=64,
        model_parallel=16, global_batch=256, checkpoint_dir=ckpt_dir,
    )
    plan = ctl.on_host_failure(["host2", "host5"])
    print(f"recovery plan: mesh={plan.mesh_shape} axes={plan.mesh_axes} "
          f"restore_step={plan.restore_step} "
          f"data_shards={plan.data_shards} dropped={plan.dropped_hosts}")

    # ---- resume on the survivors ----------------------------------------
    tbase, tpeft = attach(1, param_specs(cfg), PEFT, device="meta")
    template = TrainState.create(tbase, tpeft, opt)
    state2 = restore_resharded(ckpt_dir, plan.restore_step, template,
                               model.device)
    assert state2.step == plan.restore_step
    # deterministic pipeline: the same global token stream from step 20 on
    data2 = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=16, seed=7)
    for i in range(plan.restore_step, 30):
        state2, m2 = step_fn(state2, data2.batch(i))
    ckpt.close()
    loss_after = float(m2["loss"])
    print(f"resumed 20->30 after re-planning, loss={loss_after:.4f}")
    np.testing.assert_allclose(loss_before, loss_after, rtol=1e-5)
    print("bit-exact recovery: resumed trajectory matches the original")
    return loss_before, loss_after


if __name__ == "__main__":
    main()
