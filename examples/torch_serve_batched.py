"""Batched serving on the PyTorch port, with merged QuanTA weights (zero
inference overhead).

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
        [--base-quant nf4|int8]

The same steps as ``examples/serve_batched.py`` on the JAX package:
fine-tune briefly, merge the adapter into the weights, serve a wave of
prompts through the continuous-batching engine, and check that the merged
deployment generates the adapter-attached model's tokens.

* Admission by prefill wave: each wave is right-padded, prefilled in one
  call, and its cache stripes are scattered into free slots.
* The merged engine serves from the paged KV cache (block tables
  allocated at admission, freed on completion) while the adapted engine
  keeps dense slot stripes, so the token check also holds paged against
  dense.
* The merged engine is mesh-aware, as the JAX example's: it serves under
  ``make_host_mesh(1, 1)`` (slots and block arenas over `data`, weights
  replicated; on one device a world of one, set up when there is no
  process group: NCCL on the card, gloo on the CPU).
* Every decode tick after the first is one replay of a captured CUDA graph
  on the card (the CPU runs the same step eagerly); the capture guard's
  counts are printed.
* Multi-tenant serving: the trained QuanTA tenant and a LoRA tenant go
  into an ``AdapterBank`` over the one base, and one engine serves a
  wave that mixes both with base-model requests.

``--base-quant nf4|int8`` stores the merged weights blockwise quantized
(``ServingEngine(base_quant=)``); the reference is then a dense-cache
engine over the same quantized base.  Runs on the card by default;
``--device cpu`` runs the plain versions.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_quickstart import make_model, train  # noqa: E402

from repro_torch.core.bank import AdapterBank  # noqa: E402
from repro_torch.core.peft import PeftConfig, attach, merge_all  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.serve import Request, ServingEngine  # noqa: E402

PROMPTS = [[3, 141, 59], [26, 5], [35, 89, 79, 32], [38, 46], [2, 7, 18]]


def _serve(engine, prompts, tenants=None):
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=8,
                    adapter=tenants[i] if tenants else None)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return reqs


def main(device=None, base_quant=None):
    model = make_model(device)
    params = model.init(0)
    base, peft = attach(1, params, PeftConfig(method="quanta", n_axes=3),
                        device=model.device)
    state, _ = train(model, base, peft, steps=20, log=lambda _: None)
    merged = merge_all(state.params, state.peft)

    # serve on a mesh: slots and block arenas over `data`, weights
    # replicated (1 x 1 on one device)
    mesh = make_host_mesh(1, 1, device=model.device)
    engine = ServingEngine(model, merged, n_slots=4, max_len=64,
                           cache="paged", block_size=16, mesh=mesh,
                           base_quant=base_quant, device=model.device)
    if base_quant is None:
        ref_name = "adapter"
        ref = ServingEngine(model, state.params, state.peft, n_slots=4,
                            max_len=64, device=model.device)
    else:
        ref_name = f"{base_quant}-dense"
        ref = ServingEngine(model, merged, n_slots=4, max_len=64,
                            base_quant=base_quant, device=model.device)
    reqs_m, reqs_a = _serve(engine, PROMPTS), _serve(ref, PROMPTS)
    for rm, ra in zip(reqs_m, reqs_a):
        status = "==" if rm.output == ra.output else "!="
        print(f"req {rm.uid}: merged {rm.output} {status} {ref_name} "
              f"{ra.output}")
        assert rm.output == ra.output, f"merged serving must match {ref_name}"
    print(f"all merged-weight generations match the {ref_name} engine")
    print(f"paged engine stats: {engine.stats}")
    print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over "
          f"{mesh.size()} {mesh.device_type} rank(s); cache bytes "
          f"{engine.stats['cache_bytes_allocated']}; capture guard "
          f"{engine.compile_guard.counts()} of bounds "
          f"{engine.compilation_bounds()}")
    if base_quant is not None:
        fp = ServingEngine(model, merged, n_slots=4, max_len=64,
                           device=model.device)
        print(f"base_quant={base_quant}: param_bytes "
              f"{fp.stats['param_bytes']} fp -> "
              f"{engine.stats['param_bytes']} quantized")

    # multi-tenant: one engine, a tenant per request
    _, lora = attach(7, params, PeftConfig(method="lora", rank=4),
                     device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(8)
    for a in lora.flat().values():
        a.b.add_(0.1 * torch.randn(a.b.shape, generator=gen,
                                   device=model.device, dtype=a.b.dtype))
    bank = AdapterBank.build(params, {"quanta": (state.params, state.peft),
                                      "lora": lora})
    multi = ServingEngine(model, params, adapters=bank, n_slots=4,
                          max_len=64, device=model.device)
    tenants = ["quanta", "lora", None, "quanta", "lora"]
    reqs_b = _serve(multi, PROMPTS, tenants)
    for r, ra in zip(reqs_b, reqs_a):
        print(f"req {r.uid} [{r.adapter or 'base':6s}]: {r.output}")
        if r.adapter == "quanta" and base_quant is None:
            assert r.output == ra.output, \
                "banked tenant must match its dedicated engine"
    print(f"one engine, {bank.num_tenants} tenants + base in one decode "
          f"batch ({multi.stats['adapter_bytes']} adapter bytes)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--base-quant", default=None, choices=("nf4", "int8"),
                    help="store the merged weights blockwise quantized")
    args = ap.parse_args()
    main(args.device, args.base_quant)
