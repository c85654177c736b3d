"""repro_torch.analysis.kernels: the contract checker must PASS on the
port's kernels and FAIL on planted violations -- a checker that can't fail
checks nothing (the counterparts of ``tests/test_analysis.py``'s kernel
tests).

The records come from the real wrappers on CPU tensors (nothing launches);
each planted fault edits a recorded call or its geometry model and must be
caught by the check named in its test.  The card's describe and sentinel
checks run in ``chip_smoke.py``'s phase 14.
"""

import contextlib
import dataclasses
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import geometry
from repro_torch.analysis import kernels as ak
from repro_torch.kernels import launch_counts
from repro_torch.kernels.smem import (
    CHAIN_HEADER_INTS, CHAIN_STAGE_INTS, quantized_matmul_plan,
)

ROOT = Path(__file__).resolve().parent.parent
BUDGET = ak.SMEM_TARGET_BYTES["h100"]
JAX_NAMES = ["banked_gather", "flash_decode", "flash_fwd", "paged_decode",
             "paged_decode_quant", "quanta_apply", "quanta_linear",
             "quantized_matmul"]


@pytest.fixture(scope="module")
def cases():
    """Every family's recorded calls at the representative shapes."""
    return {name: dict(ak.family_cases(name, full=False))
            for name in ak.registered_kernels()}


def _checks(rec, launches=None, family="seed"):
    return {f.check for f in ak.check_record(family, "case", rec,
                                             smem_block=BUDGET,
                                             launches=launches)}


def _edit_writes(launch, edit):
    """``launch`` with its first write box replaced by ``edit(box)``."""
    def tiles():
        writes, reads, gathers = launch.tiles()
        return [edit(writes[0])] + writes[1:], reads, gathers
    return dataclasses.replace(launch, tiles=tiles)


def _with_operand(rec, name, **changes):
    args = dict(rec.args)
    args[name] = dataclasses.replace(args[name], **changes)
    return dataclasses.replace(rec, args=args)


# ----------------------------------------------- kernel contract checker

def test_repo_kernels_all_clean_and_registered():
    """The real kernels pass at every case, the FULL configs' among them,
    and the eight families carry the JAX package's names."""
    import repro.analysis.kernels as jax_kernels

    assert ak.registered_kernels() == JAX_NAMES
    assert ak.registered_kernels() == jax_kernels.registered_kernels()
    stats = {}
    findings = ak.check_kernels(stats=stats)
    assert findings == [], [str(f) for f in findings]
    assert stats["cases"] > 300


def test_cases_cover_every_body_and_full_config(cases):
    """Every ``__global__`` of the CUDA sources has a geometry model that
    some case reaches (the streamed chain and the split-KV decode among
    them), and every FULL config's shapes are among the cases."""
    names = set()
    for src in sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu")):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    reached = {lz.kernel for fam in cases.values() for rec in fam.values()
               for lz in geometry.model(rec)}
    assert names == reached, (names - reached, reached - names)
    plan = cases["quanta_apply"]["streamed_d2048x2"].args["plan"]
    # the last stage's chunk (its 16th int) is a part of its outputs
    stage = plan[CHAIN_HEADER_INTS + 2 * plan[0]
                 + (plan[1] - 1) * CHAIN_STAGE_INTS:]
    assert stage[15] < stage[2]
    from repro_torch.configs import ARCH_IDS

    full = ak.full_config_cases("quantized_matmul", ak.Maker("cpu"))
    archs = {c.name.split("/")[0] for c in full}
    assert archs == set(ARCH_IDS) | {"llama2-7b-proxy"}


def test_planted_out_of_bounds_tile_is_caught(cases):
    rec = cases["quantized_matmul"]["nf4_d896"]
    launches = geometry.model(rec)

    def walk_off(b):          # the last tile one tile further down
        lo = b.lo.copy()
        lo[-1, 1] += geometry.QMM_PRE_BM
        return geometry.Box(b.tensor, b.view, lo, b.hi)

    assert "in-bounds" in _checks(
        rec, [_edit_writes(launches[0], walk_off)] + launches[1:])
    assert _checks(rec, launches) == set()


def test_planted_coverage_hole_is_caught(cases):
    rec = cases["flash_fwd"]["mha_s130_pad"]
    (launch,) = geometry.model(rec)
    hole = _edit_writes(launch, lambda b: geometry.Box(
        b.tensor, b.view, b.lo[1:], b.hi[1:]))
    assert "coverage" in _checks(rec, [hole])


def test_planted_nonuniform_multiplicity_is_caught(cases):
    # one tile written twice: its elements see two writes, the rest one
    rec = cases["paged_decode"]["gqa_pool32"]
    launches = geometry.model(rec)
    twice = _edit_writes(launches[1], lambda b: geometry.Box(
        b.tensor, b.view, np.concatenate([b.lo, b.lo[:1]]),
        np.concatenate([b.hi, b.hi[:1]])))
    findings = ak.check_record("seed", "case", rec, smem_block=BUDGET,
                               launches=[launches[0], twice])
    assert [f.check for f in findings] == ["coverage"]
    assert "multiplicity [1, 2]" in findings[0].message


def test_planted_over_budget_smem_is_caught(cases):
    rec = cases["quanta_linear"]["qwen2_d896/1"]
    (launch,) = geometry.model(rec)
    over = dataclasses.replace(launch, smem=BUDGET + 16)
    assert "smem" in _checks(rec, [over])
    # and a launch that fits but differs from kernels/smem.py's budget
    assert "smem" in _checks(rec, [dataclasses.replace(
        launch, smem=launch.smem - 1024)])
    assert launch.smem == launch.budget <= BUDGET


def test_planted_bf16_partial_is_caught(cases):
    rec = cases["quantized_matmul"]["nf4_decode8_split"]
    assert rec.args["partial"].dtype == "float32"
    assert "dtype" in _checks(_with_operand(rec, "partial",
                                            dtype="bfloat16"))
    assert _checks(rec) == set()


def test_planted_out_dtype_mismatch_is_caught(cases):
    rec = cases["banked_gather"]["fused_decode_d896"]
    assert "dtype" in _checks(_with_operand(rec, "out", dtype="float16"))


def test_planted_page_id_past_pool_is_caught():
    """A table entry past the pool's rows: the real wrapper passes it on,
    the gather check catches it."""
    from repro_torch.kernels.flash_attention import (
        paged_flash_decode_attention,
    )

    tables, lens = ak._paged_tables((3, 2), 16)
    n_pool = 1 + 5
    tables[1, 1] = n_pool                      # one past the last row
    q = torch.empty((2, 1, 8, 64), dtype=torch.bfloat16)
    pool = torch.empty((n_pool, 16, 2, 64), dtype=torch.bfloat16)
    with ak.capture_launches() as records:
        paged_flash_decode_attention(q, pool, pool, torch.from_numpy(tables),
                                     torch.from_numpy(lens))
    (rec,) = records
    findings = ak.check_record("paged_decode", "seed", rec, smem_block=BUDGET)
    # both passes gather the slot's pages
    assert {f.check for f in findings} == {"in-bounds"}
    assert all("page id" in f.message for f in findings)
    tables[1, 1] = n_pool - 1
    with ak.capture_launches() as records:
        paged_flash_decode_attention(q, pool, pool, torch.from_numpy(tables),
                                     torch.from_numpy(lens))
    assert _checks(records[0]) == set()


def test_capture_records_real_wrapper_ints():
    """The capture records the production call verbatim (the wrapper's
    plan, ints and operands) while the wrapper runs unmodified, and puts
    every patch and launch count back on exit."""
    from repro_torch.core.quantize import QuantizedLinear
    from repro_torch.kernels import dispatch, quantized_matmul as qm_mod

    qw = QuantizedLinear(torch.empty((448, 1024), dtype=torch.uint8),
                         torch.empty((14, 1024)), "nf4", 64, torch.bfloat16)
    x = torch.empty((8, 896), dtype=torch.bfloat16)
    before = launch_counts()
    with ak.capture_launches() as records:
        out = qm_mod.quantized_matmul(x, qw)
        assert qm_mod.route(x) == "cuda"
    assert out.shape == (8, 1024) and out.dtype == torch.bfloat16
    (rec,) = records
    plan = quantized_matmul_plan(8, 896, 1024, True, ak.H100.sms)
    a = rec.args
    assert rec.export == "quantized_matmul_launch"
    assert (a["dtype"], a["fmt"], a["variant"], a["M"], a["N"], a["K"],
            a["bs"], a["splits"], a["smem_limit"]) == (
        1, 0, plan.variant, 8, 1024, 896, 64, plan.splits, BUDGET)
    assert a["x"].shape == (8, 896) and a["x"].dtype == "bfloat16"
    assert a["x"].contiguous and a["x"].aligned16
    assert a["packed"].shape == (448, 1024) and a["codebook"].shape == (16,)
    assert a["partial"].shape == (plan.splits, 8, 1024)
    assert a["row_norm"] is None
    # outside the context nothing is patched and no count moved
    assert qm_mod.route(x) == dispatch.route(x) == "plain"
    assert "data_ptr" not in torch.Tensor.__dict__
    assert launch_counts() == before
    with pytest.raises(RuntimeError, match="boom"):
        with ak.capture_launches():
            raise RuntimeError("boom")
    assert qm_mod.route(x) == "plain"


def test_card_check_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ak.check_kernels(["flash_fwd"], card=True, full=False)


def test_cli_lists_the_jax_families():
    """``python -m repro_torch.analysis --list`` prints the JAX CLI's
    eight names; ``--target`` takes the H100 only."""
    from repro.analysis.__main__ import main as jax_main
    from repro_torch.analysis.__main__ import main

    printed = []
    for fn in (main, jax_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(["--list"]) == 0
        printed.append(buf.getvalue().split())
    assert printed[0] == printed[1] == JAX_NAMES
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            main(["--kernels", "--target", "v5e"])
