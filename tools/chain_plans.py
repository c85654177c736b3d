#!/usr/bin/env python3
"""Time the bf16 chain (kernel 1) on mamba2-1.3b's widening x_proj chain,
(16, 16, 8) -> (32, 16, 8), whose 512 x 512 last stage tensor streams in
chunks of its outputs, under every plan that fits a block: each row tile
(8, 4, 2, 1 rows) with each micro-tile (8 x 8, 4 x 4), at a prefill
wave's 3072 rows and a decode tick's 8; the planner's own choice is
marked.  Each plan's output must equal the plain version bit for bit.

    python3 tools/chain_plans.py

Run it from the root of a checkout on a machine with one card; it builds
that checkout's kernels.  Times come from ``chip_smoke.py``'s ``timed``
(CUDA events, L2 flushed before each call).
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.quanta import QuantaAdapter, apply_sequential  # noqa: E402
from repro_torch.kernels import _build, smem  # noqa: E402
from repro_torch.kernels import quanta_apply as QA  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_plans: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"build {_build.build_all(['quanta_apply']):.1f} s", flush=True)
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    ad = QuantaAdapter.create(gen, 2048, 4096, dims_in=(16, 16, 8),
                              noise_scale=0.05, dtype=bf, device=dev)
    dims, pairs, tensors = ad.dims_in, tuple(ad.pairs), ad.tensors
    shapes = tuple(tuple(t.shape) for t in tensors)
    limit = smem.device_limits(dev).smem_block
    layout = smem.chain_layout(dims, shapes, pairs)
    planner = QA.chain_plan
    failed = 0
    try:
        for rows in (3072, 8):
            x = torch.randn((rows, 2048), generator=gen, device=dev).to(bf)
            want = apply_sequential(x, tensors, dims, pairs)
            cap = QA._row_cap(rows, smem.device_limits(dev).sms)
            chosen = planner(dims, shapes, pairs, limit, cap)
            for tile_rows in (8, 4, 2, 1):
                if tile_rows > cap:
                    continue
                for variant, (_, to) in smem.CHAIN_TILES.items():
                    chunks = smem.chain_chunks(layout, tile_rows, limit, to)
                    if chunks is None:
                        continue
                    t_elems = max(oc * st.kp
                                  for st, oc in zip(layout.stages, chunks))
                    plan = smem._make_plan(layout, tile_rows, False, variant,
                                           chunks, t_elems)
                    QA.chain_plan = (lambda *a, plan=plan, **k: plan)
                    got = QA.quanta_apply(x, tensors, dims, pairs)
                    same = torch.equal(got, want)
                    failed += not same
                    ms = cs.timed(lambda: QA.quanta_apply(x, tensors, dims,
                                                          pairs))
                    mine = ("; the planner's plan"
                            if (plan.rows, plan.variant, plan.chunks)
                            == (chosen.rows, chosen.variant, chosen.chunks)
                            else "")
                    print(f"chain_plans x_proj rows={rows}: {tile_rows} rows "
                          f"a block, {'8 x 8' if variant == 0 else '4 x 4'} "
                          f"tiles, chunks {list(chunks)}, {plan.smem} bytes: "
                          f"{ms:.4f} ms, equal to the plain version "
                          f"{same}{mine} [{card}]", flush=True)
                    QA.chain_plan = planner
    finally:
        QA.chain_plan = planner
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
