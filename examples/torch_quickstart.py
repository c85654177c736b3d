"""Quickstart on the PyTorch port: QuanTA fine-tuning in four steps.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. build a small decoder (the llama2-like SMOKE config),
2. attach QuanTA to q_proj/v_proj (zero-init via the frozen-copy fold),
3. fine-tune 40 AdamW steps on a synthetic task: only the tensors train,
4. merge the trained operator into the weights: the merged model needs
   no adapter code and matches the adapted model (paper §6).

The same steps as ``examples/quickstart.py`` on the JAX package.  Runs on
the card by default (the attention through the flash kernel and its
recompute backward); ``--device cpu`` runs the plain versions.
"""

import argparse

from repro_torch.configs import get_smoke
from repro_torch.core.peft import (
    PeftConfig, attach, merge_all, trainable_fraction,
)
from repro_torch.data import SyntheticSeq2Task
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.train import TrainState, make_train_step

STEPS = 40


def make_model(device=None):
    """The SMOKE llama2-7b-proxy decoder, its attention on the flash
    kernel (with its recompute backward)."""
    cfg = get_smoke("llama2-7b-proxy").replace(attn_backend="pallas")
    return build_model(cfg, device=device)


def train(model, base, peft, steps=STEPS, log=print):
    """40 AdamW steps at lr 5e-3 on ``SyntheticSeq2Task(seq_len=32,
    global_batch=16, task_rank=8)``.  Returns the final state and the
    loss of every step."""
    cfg = model.cfg
    opt = AdamW(lr=5e-3)
    state = TrainState.create(base, peft, opt)
    step = make_train_step(model, opt)
    data = SyntheticSeq2Task(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=16, task_rank=8)
    losses = []
    for i in range(steps):
        state, metrics = step(state, data.batch(i))
        losses.append(float(metrics["loss"]))
        if i % 10 == 0:
            log(f"step {i:3d}  loss {losses[-1]:.4f}")
    return state, losses


def merged_vs_adapted(model, state) -> float:
    """Max |logit difference| of the merged and the adapted model on a
    held-out batch."""
    cfg = model.cfg
    data = SyntheticSeq2Task(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=16, task_rank=8)
    batch = data.batch(999)
    merged = merge_all(state.params, state.peft)
    la, _ = model.forward(state.params, batch, state.peft)
    lm, _ = model.forward(merged, batch, None)
    return float((la - lm).abs().max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args()
    model = make_model(args.device)
    params = model.init(0)
    base, peft = attach(1, params, PeftConfig(method="quanta", n_axes=3),
                        device=model.device)
    print(f"trainable: {trainable_fraction(base, peft):.3f}% of parameters "
          f"({model.device})")
    state, _ = train(model, base, peft)
    err = merged_vs_adapted(model, state)
    print(f"merged-vs-adapted max |logit diff| = {err:.2e}  "
          f"(zero inference overhead)")
    assert err < 1e-3


if __name__ == "__main__":
    main()
