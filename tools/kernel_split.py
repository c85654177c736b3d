#!/usr/bin/env python3
"""Time the adapted linear (kernel 2) and the paged decodes (kernels 5 and
6), and the bf16 flash forward and dense decode beside them, at the main
path's bf16 shapes (llama2-7b-proxy, 8 slots), and the flash forward at
recurrentgemma-2b's head_dim of 256 (10 query heads over 1, 8 x 384 and
one 2600-token prompt under its 2048 window) beside SDPA, each kernel
call also split into the kernels it launches.

    python3 tools/kernel_split.py

Run it from the root of a checkout on a machine with one card; it builds
that checkout's kernels.  Times come from ``chip_smoke.py``'s ``timed``
(CUDA events, L2 flushed before each call) and ``launch_split``
(``torch.profiler``); run two checkouts in turns to compare them.
"""
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.factorize import pair_schedule  # noqa: E402
from repro_torch.core.quanta import apply_einsum, tensor_shapes  # noqa: E402
from repro_torch.core.quantize import quantize_kv  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels.quanta_apply import quanta_apply  # noqa: E402
from repro_torch.kernels.quanta_linear import quanta_linear  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card {card} | {ROOT} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    secs = _build.build_all(["quanta_apply", "quanta_linear",
                             "flash_attention"])
    print(f"build {secs:.1f} s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    dims = (16, 8, 8, 4)
    pairs = pair_schedule(4)
    d = math.prod(dims)
    tensors = [(torch.eye(om * on, im * i_n, device=dev).reshape(
        om, on, im, i_n) + 0.05 * torch.randn(
            (om, on, im, i_n), generator=gen, device=dev)).to(bf)
        for om, on, im, i_n in tensor_shapes(dims, pairs)]
    w = (torch.randn((d, d), generator=gen, device=dev) * d ** -0.5).to(bf)

    def line(label, fn):
        print(f"{label}: {cs.timed(fn):.4f} ms; split "
              f"{cs.split_text(cs.launch_split(fn))} [{card}]", flush=True)

    for rows in (3072, 8, 1001):
        x = torch.randn((rows, d), generator=gen, device=dev).to(bf)
        line(f"quanta_linear rows={rows}",
             lambda: quanta_linear(x, w, tensors, dims, pairs))
        chain = cs.timed(lambda: quanta_apply(x, tensors, dims, pairs))
        lib = cs.timed(lambda: torch.matmul(x, w)
                       + apply_einsum(x, tensors, dims, pairs))
        print(f"quanta_linear rows={rows}: chain alone {chain:.4f}; matmul "
              f"{cs.timed(lambda: torch.matmul(x, w)):.4f}; matmul + einsum "
              f"{lib:.4f} [{card}]", flush=True)
    b, h, hd, s_max, bs = 8, 32, 128, 512, 16
    q = torch.randn((b, 384, h, hd), generator=gen, device=dev).to(bf)
    line("flash_attention S=384", lambda: FA.flash_attention(q, q, q))
    n_b = s_max // bs
    n_blocks = b * n_b + 1
    lens = torch.tensor([33, 100, 385, 512, 1, 64, 65, 200],
                        dtype=torch.int32, device=dev)
    tables = cs.paged_tables(lens.tolist(), bs, n_b, n_blocks, seed=5).to(dev)
    kp = torch.randn((n_blocks, bs, h, hd), generator=gen, device=dev).to(bf)
    vp = torch.randn((n_blocks, bs, h, hd), generator=gen, device=dev).to(bf)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(bf)
    kc, vc = FA.gather_kv(q, kp, vp, tables)
    line("flash_decode_attention S_max=512",
         lambda: FA.flash_decode_attention(q, kc, vc, lens))
    line("paged_flash_decode_attention rows S_max=512",
         lambda: FA.paged_flash_decode_attention(q, kp, vp, tables, lens))
    for quant in ("nf4", "int8"):
        (kq, ks), (vq, vs) = quantize_kv(kp, quant), quantize_kv(vp, quant)
        for window in (None, 50):
            line(f"paged_flash_decode_attention_quant {quant} "
                 f"window={window} S_max=512",
                 lambda: FA.paged_flash_decode_attention(
                     q, kq, vq, tables, lens, window=window, kv_quant=quant,
                     k_scales=ks, v_scales=vs))
    for b, s, window in ((8, 384, None), (1, 2600, 2048)):
        q, k = (torch.randn((b, s, n, 256), generator=gen,
                            device=dev).to(bf) for n in (10, 1))
        label = f"flash_attention hd=256 ({b}, {s}) window={window}"
        line(label, lambda: FA.flash_attention(q, k, k, window=window))
        band = None            # SDPA: causal, or the band as a mask
        if window is not None:
            i = torch.arange(s, device=dev)
            band = ((i[:, None] >= i[None, :])
                    & (i[:, None] - i[None, :] < window))
        qt, kt = q.transpose(1, 2), k.transpose(1, 2)
        sdpa = cs.timed(lambda: F.scaled_dot_product_attention(
            qt, kt, kt, attn_mask=band, is_causal=band is None,
            enable_gqa=True))
        print(f"{label}: SDPA {sdpa:.4f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
