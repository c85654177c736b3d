"""End-to-end fine-tuning on the PyTorch port: data pipeline -> QuanTA ->
train loop -> async checkpointing -> resume -> held-out eval.

    PYTHONPATH=src python examples/torch_finetune_e2e.py [--steps 200]
        [--big] [--ckpt-dir DIR] [--resume] [--device cpu]

The same steps as ``examples/finetune_e2e.py`` on the JAX package, whose
checkpoints it reads and writes (the two packages share the on-disk
format).  The default is a ~1M-parameter model; ``--big`` a ~100M
decoder.  ``--resume`` restores the newest checkpoint under
``--ckpt-dir`` onto a ``meta``-device template (``param_specs``,
``attach`` and ``TrainState.create`` on ``meta``: the port's
``jax.eval_shape``) and trains on from its step.  Runs on the card by
default (the attention through the flash kernel and its recompute
backward); ``--device cpu`` runs the plain versions.
"""

import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.core.peft import PeftConfig, attach, count_params
from repro_torch.data import SyntheticSeq2Task
from repro_torch.models import build_model, param_specs
from repro_torch.models.common import ModelConfig
from repro_torch.optim import AdamW, linear_warmup_schedule
from repro_torch.train import TrainState, make_train_step

SMALL = ModelConfig(name="e2e-small", family="dense", n_layers=2,
                    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                    d_ff=176, vocab_size=256, q_block=32,
                    attn_backend="pallas")
BIG = ModelConfig(name="e2e-100m", family="dense", n_layers=8,
                  d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                  d_ff=2048, vocab_size=32000, q_block=128,
                  attn_backend="pallas")
PEFT = PeftConfig(method="quanta", n_axes=3, scheme=None)


def meta_template(cfg: ModelConfig, opt: AdamW) -> TrainState:
    """The train state's structure, shapes and dtypes on ``meta``."""
    base, peft = attach(1, param_specs(cfg), PEFT, device="meta")
    return TrainState.create(base, peft, opt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true",
                    help="~100M-parameter model")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)

    cfg = BIG if args.big else SMALL
    seq_len = 256 if args.big else 32
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    base, peft = attach(1, params, PEFT, device=model.device)
    print(f"base params: {count_params(base):,}  "
          f"trainable: {count_params(peft):,}  ({model.device})")

    opt = AdamW(lr=linear_warmup_schedule(5e-3, args.steps, args.steps // 10))
    state = TrainState.create(base, peft, opt)
    step_fn = make_train_step(model, opt, microbatches=2)

    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"quanta_torch_e2e_{cfg.name}"
    )
    ckpt = AsyncCheckpointer(ckpt_dir, keep=2)
    start = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        start = latest_step(ckpt_dir)
        state = restore(ckpt_dir, start, meta_template(cfg, opt),
                        device=model.device)
        print(f"resumed from step {start}")

    data = SyntheticSeq2Task(vocab_size=cfg.vocab_size, seq_len=seq_len,
                             global_batch=16, task_rank=16)
    for i in range(start, args.steps):
        state, metrics = step_fn(state, data.batch(i))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(metrics['loss']):.4f}  "
                  f"|g| {float(metrics['grad_norm']):.3f}")
        if i and i % 50 == 0:
            ckpt.save(i, state)
    ckpt.save(args.steps, state)
    ckpt.close()
    print(f"checkpoints in {ckpt_dir}: latest={latest_step(ckpt_dir)}")

    # eval: answer accuracy on held-out batches
    correct = total = 0
    with torch.no_grad():
        for i in range(10):
            b = data.batch(10_000 + i)
            logits, _ = model.forward(state.params, {"tokens": b["tokens"]},
                                      state.peft)
            labels = torch.as_tensor(b["labels"], device=logits.device)
            mask = labels >= 0
            pred = logits[..., : cfg.vocab_size].argmax(-1)
            correct += int(((pred == labels) & mask).sum())
            total += int(mask.sum())
    acc = correct / max(total, 1)
    print(f"held-out answer accuracy: {acc:.3f}")
    return state, acc


if __name__ == "__main__":
    main()
