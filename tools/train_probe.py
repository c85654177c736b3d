#!/usr/bin/env python3
"""Two training readings beside ``chip_smoke.py``'s train phase, which
judges neither.

    python3 tools/train_probe.py

1. apart: llama2-7b-proxy cut to 2 layers in float32 trains 5 AdamW
   steps through kernel 3 and, from the same start, 5 through the
   reference attention; each step's loss and grad norm of both runs and
   their largest relative difference (why ``chip_smoke.py`` holds the two
   routes on one state at every step instead of two runs);
2. shapes: llama2-7b-proxy FULL (bf16, folded QuanTA 16-8-8-4 on q/v)
   takes one training step, then one more under ``torch.profiler`` with
   input shapes recorded: the device time of the elementwise products
   and copies by input shape.

Run it from the root of a checkout on a machine with one card; it builds
that checkout's kernels.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticSeq2Task  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402


def apart(dev, cut, card):
    model, base, peft = cs._train_models(cut, dev, 600)
    plain = type(model)(model.cfg.replace(attn_backend="reference"),
                        device=dev)
    got, _, _, _ = cs._run_steps(model, base, peft, 5, cs.TRAIN_SEQ,
                                 cs.TRAIN_BATCH)
    want, _, _, _ = cs._run_steps(plain, base, peft, 5, cs.TRAIN_SEQ,
                                  cs.TRAIN_BATCH)
    rel = [max(abs(a - b) / abs(b) for a, b in zip(g, w))
           for g, w in zip(got, want)]
    print(f"apart: f32 cut, 5 steps (loss, grad norm) through kernel 3 "
          f"{got}; through the reference attention {want}; max rel by step "
          f"{[f'{r:.3e}' for r in rel]} [{card}]")


def shapes(dev, full, card):
    model, base, peft = cs._train_models(full.replace(attn_backend="pallas"),
                                         dev, 800)
    opt = AdamW(lr=5e-3, max_grad_norm=1.0)
    state = TrainState.create(base, peft, opt)
    step = make_train_step(model, opt)
    data = SyntheticSeq2Task(vocab_size=full.vocab_size, seq_len=cs.TRAIN_SEQ,
                             global_batch=cs.TRAIN_BATCH, task_rank=8, seed=0)
    state, _ = step(state, data.batch(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(state, data.batch(1))
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.key, e.count, e.input_shapes)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.device_type.name == "CPU"
            and e.key in ("aten::mul", "aten::copy_")]
    for ms, key, n, shp in sorted(rows, key=lambda r: -r[0])[:8]:
        print(f"shapes: {key[6:]} {ms:.2f} ms over {n} calls, input shapes "
              f"{str(shp)[:160]} [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build_all(["flash_attention"])
    dev = torch.device("cuda")
    full = get_config("llama2-7b-proxy")
    apart(dev, full.replace(n_layers=2, param_dtype=torch.float32,
                            compute_dtype=torch.float32,
                            attn_backend="pallas"), card)
    shapes(dev, full, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
