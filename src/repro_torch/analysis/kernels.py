"""Kernel-contract checker for the port's CUDA kernels (port of
``repro/analysis/kernels.py``).

Every hand-written kernel rests on invariants its launcher keeps by hand:
the grid covers each output exactly once (each fp32 partial once per
split, the reduce or combine covering the output once), every block's tile
starts inside its tensor and every page id it gathers lies in the pool,
the dynamic shared memory fits the block's opt-in limit and equals the
``kernels/smem.py`` budget the wrapper dispatched on, and the dtype
discipline holds (the output in x's dtype, partials and accumulators fp32,
tables and lengths int32).  CUDA checks none of this at compile time; a
violation surfaces as wrong numbers or a fault on the card.

This module checks all of it **on the CPU, with no card and no kernel
run**:

* :func:`capture_launches` patches, inside its context only, the
  ``ctypes`` boundary: ``kernels/_build.load`` (each ``*_launch`` export
  records its call and launches nothing), ``_build.stream_ptr``, the
  wrappers' ``route`` / ``device_route`` (they answer ``"cuda"``) and
  ``smem.device_limits`` (an H100 SXM: 132 SMs, 232448 bytes a block).
  The REAL wrappers (``kernels/*.py``) then run on CPU tensors, and each
  record keeps the ints exactly as the wrapper passed them and, for each
  pointer operand, the tensor's shape, dtype, contiguity and 16-byte
  alignment (int32 operands' contents too: tables, lengths, ids); the
  contract cannot drift from the wrappers.
* :mod:`repro_torch.analysis.geometry` models each entry point's launches
  from those ints: grids, threads, shared memory, and every block's tiles.
* :func:`check_record` runs the checks, under the JAX checker's names:
  ``grid``, ``in-bounds``, ``coverage``, ``smem`` (the port's ``vmem``)
  and ``dtype``.

The cases are the JAX builders' representative shapes (ragged extents,
windows, GQA groups, non-divisible caches) and every FULL config's kernel
shapes at 3072 prefill rows and 8 decode rows; together they reach every
body (bf16 wgmma prefill, bf16 split-K decode, float32 SIMT, the streamed
chain, the split-KV decode).

On the card, ``check_kernels(card=True)`` adds two checks that hold the
Python model to the C++: each case's ``*_describe`` export (the launcher's
own geometry, computed by the function its launch uses) must equal the
model (a difference is a ``grid`` finding), and a sentinel run of the
ragged cases launches the real kernels with each output and a 64-byte
guard band on each side filled with NaN: every output element must come
back finite and every guard band untouched.

Registering a new kernel family::

    @register_kernel("my_kernel")
    def _my_cases(make):
        x = make.t((rows, d), torch.bfloat16)
        return [Case("main", lambda: my_wrapper(x))]

then ``python -m repro_torch.analysis --check`` covers it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import geometry
from repro_torch.analysis.geometry import Box, Launch
from repro_torch.kernels.smem import DeviceLimits

__all__ = [
    "Operand",
    "LaunchRecord",
    "Finding",
    "Case",
    "SMEM_TARGET_BYTES",
    "H100",
    "capture_launches",
    "check_record",
    "register_kernel",
    "registered_kernels",
    "family_cases",
    "check_kernels",
    "describe",
]

# Cap on the blocks of one launch: the tiles are enumerated (as numpy
# arrays), so a grid that cannot be enumerated is refused.
MAX_GRID_POINTS = 1 << 21
MAX_GRID_YZ = 65535            # gridDim.y and gridDim.z
MAX_GRID_X = 2 ** 31 - 1
MAX_THREADS = 1024
GUARD_BYTES = 64               # the sentinel run's band on each side
# a describe export's result (csrc/geometry.cuh kMaxLaunches, kInts):
# grid x, y, z, threads, dynamic shared memory a launch
DESCRIBE_LAUNCHES, DESCRIBE_INTS = 4, 5

# the shared memory one block may opt in to, by target
SMEM_TARGET_BYTES = {"h100": 232448}


# the card the checker plans for: an H100 SXM
H100 = DeviceLimits(132, SMEM_TARGET_BYTES["h100"])


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Operand:
    """A pointer argument: the tensor behind it, as the wrapper passed it."""

    shape: Tuple[int, ...]
    dtype: str                     # "float32", "bfloat16", "int32", ...
    contiguous: bool
    aligned16: bool
    ptr: int
    values: Optional[np.ndarray] = None   # an int32 operand's contents

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


@dataclasses.dataclass
class LaunchRecord:
    """One call of a ``*_launch`` export: ``args`` by the C parameter names
    (ints and floats as passed, pointers as :class:`Operand` or ``None``,
    ``int*`` arrays as tuples, pointer arrays as lists of operands);
    ``raw`` the call's arguments in order, for the describe export."""

    export: str
    args: Dict[str, Any]
    raw: Tuple[Any, ...]


# the C signature of each export: name:kind, kinds i int, q long long,
# f float, p pointer, ia int array, pa pointer array, s stream
_SIGNATURES = {
    "flash_forward_launch":
        "dtype:i q:p k:p v:p o:p B:i S:i H:i KV:i hd:i window:i scale:f "
        "smem_limit:i stream:s",
    "flash_decode_launch":
        "dtype:i q:p kc:p vc:p lens:p o:p B:i S_max:i H:i KV:i hd:i "
        "window:i scale:f smem_limit:i stream:s",
    "paged_decode_launch":
        "dtype:i fmt:i q:p k:p v:p ks:p vs:p codebook:p tables:p lens:p o:p "
        "B:i n_b:i bs:i H:i KV:i hd:i qb:i window:i scale:f smem_limit:i "
        "stream:s",
    "split_decode_launch":
        "q:p k:p v:p tables:p lens:p o:p scores:p B:i extent:i n_b:i bs:i "
        "H:i KV:i hd:i window:i chunk_tiles:i splits:i stages:i scale:f "
        "smem_limit:i stream:s",
    "quant_split_decode_launch":
        "fmt:i q:p kq:p vq:p ks:p vs:p codebook:p tables:p lens:p o:p "
        "scores:p B:i n_b:i bs:i H:i KV:i hd:i qb:i window:i chunk_tiles:i "
        "splits:i stages:i scale:f smem_limit:i stream:s",
    "quanta_apply_launch":
        "dtype:i x:p out:p rows:q meta:ia tensors:pa rows_per_block:i "
        "smem_limit:i stream:s",
    "quanta_chain_bf16_launch":
        "x:p out:p rows:q plan:ia n_plan:i tensors:pa smem_bytes:i "
        "smem_limit:i stream:s",
    "quanta_linear_gemm_launch":
        "dtype:i variant:i x:p w:p delta:p part:p out:p M:i N:i K:i ldd:i "
        "dcol:i splits:i smem_limit:i stream:s",
    "quantized_matmul_launch":
        "dtype:i fmt:i variant:i x:p packed:p scales:p row_norm:p "
        "col_norm:p codebook:p out:p partial:p M:i N:i K:i bs:i splits:i "
        "smem_limit:i stream:s",
    "banked_lora_launch":
        "x_dtype:i a_dtype:i variant:i x:p a:p b:p ids:p w:p za:p zpart:p "
        "gpart:p out:p n_slots:i S:i d_in:i d_out:i r:i n_bank:i scale:f "
        "splits:i k_split:i gsplits:i smem_limit:i stream:s",
}
SIGNATURES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    name: tuple(tuple(p.split(":")) for p in sig.split())
    for name, sig in _SIGNATURES.items()
}
# the library (csrc/<name>.cu) of each export
LIBRARY = {
    "flash_forward_launch": "flash_attention",
    "flash_decode_launch": "flash_attention",
    "paged_decode_launch": "flash_attention",
    "split_decode_launch": "flash_attention",
    "quant_split_decode_launch": "flash_attention",
    "quanta_apply_launch": "quanta_apply",
    "quanta_chain_bf16_launch": "quanta_apply",
    "quanta_linear_gemm_launch": "quanta_linear",
    "quantized_matmul_launch": "quantized_matmul",
    "banked_lora_launch": "banked_gather",
}
# the dtype contract of each export: (the output, the operand whose dtype
# it has), the operands that must be float32, those that must be int32
DTYPES = {
    "flash_forward_launch": (("o", "q"), (), ()),
    "flash_decode_launch": (("o", "q"), (), ("lens",)),
    "paged_decode_launch": (("o", "q"), ("ks", "vs"), ("tables", "lens")),
    "split_decode_launch": (("o", "q"), ("scores",), ("tables", "lens")),
    "quant_split_decode_launch":
        (("o", "q"), ("scores", "ks", "vs"), ("tables", "lens")),
    "quanta_apply_launch": (("out", "x"), (), ()),
    "quanta_chain_bf16_launch": (("out", "x"), (), ()),
    "quanta_linear_gemm_launch": (("out", "x"), ("part",), ()),
    "quantized_matmul_launch": (("out", "x"), ("partial", "scales"), ()),
    "banked_lora_launch": (("out", "x"), ("za", "zpart", "gpart"), ("ids",)),
}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _operand(t: torch.Tensor) -> Operand:
    values = None
    if t.dtype == torch.int32 and t.numel() <= 1 << 16:
        values = t.detach().cpu().numpy().copy()
    ptr = t.data_ptr()
    return Operand(tuple(t.shape), _dtype_name(t.dtype), t.is_contiguous(),
                   ptr % 16 == 0, ptr, values)


def _plain(v):
    """A ctypes argument as a Python value (pointers as ints or None)."""
    if isinstance(v, ctypes.Array):
        return tuple(_plain(e) for e in v)
    if isinstance(v, (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)):
        return v.value
    return v


# ---------------------------------------------------------------------------
# The capture context
# ---------------------------------------------------------------------------

class _Export:
    """Stands in for one ``*_launch`` export: records its call; in the
    sentinel run also launches the real export over guarded outputs."""

    def __init__(self, name: str, state: "_Capture"):
        self.name = name
        self.state = state
        self.argtypes = None
        self.restype = None

    def __call__(self, *args):
        state = self.state
        sig = SIGNATURES[self.name]
        if len(args) != len(sig):
            raise TypeError(f"{self.name} takes {len(sig)} arguments, the "
                            f"wrapper passed {len(args)}")
        plain = [_plain(a) for a in args]
        named: Dict[str, Any] = {}
        tensors: Dict[str, torch.Tensor] = {}
        for (arg, kind), v in zip(sig, plain):
            if kind == "p":
                t = state.seen.get(v) if v else None
                if v and t is None:
                    raise RuntimeError(f"{self.name}: pointer {arg} is not "
                                       "the data of a tensor the wrapper "
                                       "passed")
                named[arg] = None if t is None else _operand(t)
                if t is not None:
                    tensors[arg] = t
            elif kind == "pa":
                named[arg] = [_operand(state.seen[p]) for p in v]
            elif kind != "s":
                named[arg] = v
        rec = LaunchRecord(self.name, named, tuple(plain))
        state.records.append(rec)
        rc = 0
        if state.launch:
            rc = _guarded_call(self, rec, list(args), tensors, state)
        state.seen.clear()
        return rc


class _Library:
    def __init__(self, state: "_Capture"):
        self._state = state
        self._exports: Dict[str, _Export] = {}

    def __getattr__(self, export: str) -> _Export:
        if export.startswith("_"):
            raise AttributeError(export)
        if export not in SIGNATURES:
            raise AttributeError(f"the recorder knows no export {export}")
        if export not in self._exports:
            self._exports[export] = _Export(export, self._state)
        return self._exports[export]


@dataclasses.dataclass
class _Capture:
    records: List[LaunchRecord]
    launch: bool
    findings: List[Tuple[str, str, str]]
    seen: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    real_load: Optional[Callable] = None


def _wrapper_modules():
    from repro_torch.kernels import (
        banked_gather, dispatch, flash_attention, quanta_apply,
        quanta_linear, quantized_matmul, smem,
    )
    return (dispatch, smem, flash_attention, quanta_apply, quanta_linear,
            quantized_matmul, banked_gather)


@contextlib.contextmanager
def capture_launches(records: Optional[List[LaunchRecord]] = None, *,
                     launch: bool = False,
                     findings: Optional[List[Tuple[str, str, str]]] = None):
    """Record every ``*_launch`` call the wrappers make inside the context.

    With ``launch=False`` (the CPU checker) nothing is launched: the
    wrappers run on CPU tensors as if on an H100 and each export returns
    success.  With ``launch=True`` (the sentinel run, on the card) the
    wrappers run on CUDA tensors and each export also launches the real
    kernel over guarded outputs (:func:`_guarded_call`), appending
    ``(check, export, message)`` to ``findings``.  Every patch, and every
    wrapper's launch count, is put back on exit, on an exception too."""
    from repro_torch.kernels import KERNELS, _build, dispatch

    if records is None:
        records = []
    state = _Capture(records, launch, [] if findings is None else findings)
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    patches: List[Tuple[Any, str, Any]] = []

    def patch(obj, attr, value):
        patches.append((obj, attr, obj.__dict__.get(attr, _MISSING)))
        setattr(obj, attr, value)

    real_data_ptr = torch.Tensor.data_ptr

    def data_ptr(self):
        p = real_data_ptr(self)
        state.seen[p] = self
        return p

    state.real_load = _build.load
    libraries = {}

    def load(name):
        if name not in libraries:
            libraries[name] = _Library(state)
        return libraries[name]

    try:
        patch(torch.Tensor, "data_ptr", data_ptr)
        patch(_build, "load", load)
        if not launch:
            patch(_build, "stream_ptr", lambda: ctypes.c_void_p(0))
            limits = H100
            for mod in _wrapper_modules():
                if "route" in mod.__dict__:
                    patch(mod, "route", lambda *t: "cuda")
                if "device_limits" in mod.__dict__:
                    patch(mod, "device_limits", lambda dev: limits)
            patch(dispatch, "device_route", lambda *t: "cuda")
        yield records
    finally:
        for obj, attr, old in reversed(patches):
            if old is _MISSING:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
        for name, fn in KERNELS.items():
            fn.launches = counts[name]


_MISSING = object()


def _guarded_call(export: _Export, rec: LaunchRecord, args: list,
                  tensors: Dict[str, torch.Tensor], state: _Capture) -> int:
    """Launch the real export with each output it writes (and a
    ``GUARD_BYTES`` band on each side) filled with NaN; afterwards every
    final output must be finite and every band unchanged.  The results go
    back into the wrapper's tensors."""
    fn = getattr(state.real_load(LIBRARY[export.name]), export.name)
    fn.argtypes, fn.restype = export.argtypes, export.restype
    written, finals = geometry.OUTPUTS[export.name]
    names = [n for n, _ in SIGNATURES[export.name]]
    guarded = []
    for name in written:
        t = tensors.get(name)
        if t is None:
            continue
        nbytes = t.numel() * t.element_size()
        buf = torch.empty(nbytes + 2 * GUARD_BYTES, dtype=torch.uint8,
                          device=t.device)
        buf.view(t.dtype).fill_(float("nan"))
        before = buf.clone()
        mid = buf[GUARD_BYTES:GUARD_BYTES + nbytes]
        args[names.index(name)] = ctypes.c_void_p(mid.data_ptr())
        guarded.append((name, t, buf, before, mid))
    rc = fn(*args)
    torch.cuda.synchronize()
    for name, t, buf, before, mid in guarded:
        for side, sl in (("before", slice(0, GUARD_BYTES)),
                         ("after", slice(buf.numel() - GUARD_BYTES, None))):
            if not torch.equal(buf[sl], before[sl]):
                state.findings.append((
                    "in-bounds", export.name,
                    f"{name}: the {GUARD_BYTES}-byte guard band {side} it "
                    "was written"))
        if name in finals and rc == 0:
            bad = int((~torch.isfinite(mid.view(t.dtype))).sum())
            if bad:
                state.findings.append((
                    "coverage", export.name,
                    f"{name}: {bad} of {t.numel()} elements not finite "
                    "after the launch (never written)"))
        t.view(-1).view(torch.uint8).copy_(mid)
    return rc


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Finding:
    kernel: str
    case: str
    check: str        # "grid" | "in-bounds" | "coverage" | "smem" | "dtype"
    message: str

    def __str__(self) -> str:
        return f"[{self.kernel}/{self.case}] {self.check}: {self.message}"


def _coverage(view: Tuple[int, ...], boxes: Sequence[Box]):
    """Write counts of the elements of ``view`` over ``boxes``: the
    coordinates are compressed to the tiles' edges and the counts summed
    from a difference array, so the cost follows the tiles, not the
    elements.  Returns (elements never written, elements written more
    than once, the counts seen)."""
    lo = np.concatenate([b.lo for b in boxes])
    hi = np.concatenate([b.hi for b in boxes])
    vw = np.asarray(view, np.int64)
    lo = np.clip(lo, 0, vw)
    hi = np.clip(hi, 0, vw)
    keep = np.all(hi > lo, axis=1)
    lo, hi = lo[keep], hi[keep]
    d = len(view)
    coords = [np.unique(np.concatenate([[0, view[k]], lo[:, k], hi[:, k]]))
              for k in range(d)]
    li = [np.searchsorted(coords[k], lo[:, k]) for k in range(d)]
    hj = [np.searchsorted(coords[k], hi[:, k]) for k in range(d)]
    diff = np.zeros([len(c) for c in coords], np.int64)
    for corner in itertools.product((0, 1), repeat=d):
        idx = tuple(hj[k] if c else li[k] for k, c in enumerate(corner))
        np.add.at(diff, idx, -1 if sum(corner) % 2 else 1)
    for k in range(d):
        diff = np.cumsum(diff, axis=k)
    cells = diff[tuple(slice(0, len(c) - 1) for c in coords)]
    sizes = functools.reduce(np.multiply.outer,
                             [np.diff(c) for c in coords]) if d > 1 \
        else np.diff(coords[0])
    holes = int(sizes[cells == 0].sum())
    multi = int(sizes[cells > 1].sum())
    return holes, multi, sorted(set(np.unique(cells).tolist()))


def check_record(kernel: str, case: str, rec: LaunchRecord, *,
                 smem_block: int,
                 launches: Optional[List[Launch]] = None) -> List[Finding]:
    """Every contract check for one recorded call; ``launches`` replaces
    the geometry model's (a planted fault)."""
    findings: List[Finding] = []

    def add(check: str, message: str) -> None:
        findings.append(Finding(kernel, case, check, message))

    try:
        if launches is None:
            launches = geometry.model(rec)
    except (KeyError, ValueError) as e:
        add("grid", f"{rec.export}: no geometry for this call ({e})")
        return findings

    # --- grid: enumerable, within CUDA's limits
    for lz in launches:
        gx, gy, gz = lz.grid
        if lz.points > MAX_GRID_POINTS:
            add("grid", f"{lz.kernel}: grid {lz.grid} has {lz.points} "
                f"blocks, over the {MAX_GRID_POINTS} enumeration cap")
            return findings
        if min(lz.grid) < 1 or gx > MAX_GRID_X or gy > MAX_GRID_YZ \
                or gz > MAX_GRID_YZ:
            add("grid", f"{lz.kernel}: grid {lz.grid} outside CUDA's "
                f"limits (x <= {MAX_GRID_X}, y, z <= {MAX_GRID_YZ})")
        if not 1 <= lz.threads <= MAX_THREADS:
            add("grid", f"{lz.kernel}: {lz.threads} threads a block")

    # --- smem: within the block's limit, equal to the wrapper's budget
    for lz in launches:
        total = lz.smem + lz.static_smem
        if total > smem_block:
            add("smem", f"{lz.kernel}: {total} bytes of shared memory a "
                f"block, over the {smem_block}-byte limit")
        if lz.budget is not None and total != lz.budget:
            add("smem", f"{lz.kernel}: launched with {total} bytes of "
                f"shared memory, but kernels/smem.py budgets {lz.budget}")

    # --- in-bounds: every tile starts inside its tensor, every gathered
    # index inside what it indexes
    written: Dict[str, List[Box]] = {}
    for lz in launches:
        writes, reads, gathers = lz.tiles()
        for bx in writes + reads:
            op = rec.args.get(bx.tensor)
            if op is None:
                add("in-bounds", f"{lz.kernel}: touches {bx.tensor}, a "
                    "null pointer")
                continue
            need = int(np.prod(bx.view, dtype=np.int64))
            if need > op.numel:
                add("in-bounds", f"{lz.kernel}: {bx.tensor} read as "
                    f"{bx.view} ({need} elements), but it holds "
                    f"{op.numel} {op.shape}")
            if len(bx.lo) == 0:
                continue
            out = (bx.lo < 0) | (bx.lo >= np.asarray(bx.view, np.int64))
            bad = np.nonzero(out.any(axis=1))[0]
            if len(bad):
                i = int(bad[0])
                add("in-bounds", f"{lz.kernel}: {len(bad)} tile(s) of "
                    f"{bx.tensor} start outside its {bx.view} (e.g. at "
                    f"{tuple(int(v) for v in bx.lo[i])})")
        for g in gathers:
            ids = np.asarray(g.ids)
            bad = ids[(ids < 0) | (ids >= g.limit)]
            if len(bad):
                add("in-bounds", f"{lz.kernel}: {len(bad)} {g.what} id(s) "
                    f"outside [0, {g.limit}) (e.g. {int(bad[0])})")
        for bx in writes:
            written.setdefault(bx.tensor, []).append(bx)

    # --- coverage: each written tensor exactly once, the outputs written
    _, finals = geometry.OUTPUTS[rec.export]
    for name in finals:
        if name not in written:
            add("coverage", f"{name} is never written")
    for name, boxes in written.items():
        views = {bx.view for bx in boxes}
        if len(views) != 1:
            add("coverage", f"{name} is written as {sorted(views)}")
            continue
        view = views.pop()
        holes, multi, counts = _coverage(view, boxes)
        total = int(np.prod(view, dtype=np.int64))
        if holes:
            add("coverage", f"{name}: {holes} of {total} elements never "
                "written")
        if multi:
            add("coverage", f"{name}: non-uniform write multiplicity "
                f"{counts}: {multi} elements written more than once")

    # --- dtype
    (out_name, like), fp32, int32 = DTYPES[rec.export]
    out, ref = rec.args.get(out_name), rec.args.get(like)
    if out is not None and ref is not None and out.dtype != ref.dtype:
        add("dtype", f"{out_name} dtype {out.dtype} != {like} dtype "
            f"{ref.dtype}")
    for name in fp32:
        op = rec.args.get(name)
        if op is not None and op.dtype != "float32":
            add("dtype", f"{name} is {op.dtype}, not float32: partials, "
                "scratch and scales must be fp32")
    for name in int32:
        op = rec.args.get(name)
        if op is not None and op.dtype != "int32":
            add("dtype", f"{name} is {op.dtype}, not int32")
    return findings


# ---------------------------------------------------------------------------
# The describe exports (on the card)
# ---------------------------------------------------------------------------

_CTYPES = {"i": ctypes.c_int, "q": ctypes.c_longlong, "f": ctypes.c_float,
           "p": ctypes.c_void_p, "ia": ctypes.POINTER(ctypes.c_int),
           "pa": ctypes.POINTER(ctypes.c_void_p)}


def describe(rec: LaunchRecord) -> Tuple[int, List[Tuple[int, ...]]]:
    """The C++ side's geometry for ``rec``: the ``*_describe`` twin of its
    export called with the recorded arguments (pointers as numbers, never
    read).  Returns ``(rc, launches)``, ``rc`` negative when the launcher
    would refuse the call.  Needs the built library (nvcc)."""
    from repro_torch.kernels import _build

    sig = SIGNATURES[rec.export]
    name = rec.export.replace("_launch", "_describe")
    fn = getattr(_build.load(LIBRARY[rec.export]), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [_CTYPES[k] for _, k in sig[:-1]] + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    args = []
    for (_, kind), v in zip(sig[:-1], rec.raw[:-1]):
        if kind == "ia":
            v = (ctypes.c_int * len(v))(*v)
        elif kind == "pa":
            v = (ctypes.c_void_p * len(v))(*v)
        elif kind == "p":
            v = ctypes.c_void_p(v)
        args.append(v)
    cap = DESCRIBE_LAUNCHES * DESCRIBE_INTS
    out = (ctypes.c_int * cap)()
    rc = fn(*args, out, cap)
    return rc, [tuple(out[DESCRIBE_INTS * i:DESCRIBE_INTS * (i + 1)])
                for i in range(max(rc, 0))]


def check_describe(kernel: str, case: str, rec: LaunchRecord,
                   launches: Optional[List[Launch]] = None
                   ) -> List[Finding]:
    """The describe export against the geometry model (``grid``)."""
    if launches is None:
        launches = geometry.model(rec)
    rc, got = describe(rec)
    want = [lz.ints() for lz in launches]
    if rc < 0:
        return [Finding(kernel, case, "grid", f"{rec.export} refuses the "
                        f"call (error {-rc}); the model has {want}")]
    if got != want:
        return [Finding(kernel, case, "grid", f"{rec.export}: the "
                        f"launcher's geometry {got} != the model's {want} "
                        "(grid x, y, z, threads, dynamic shared memory)")]
    return []


# ---------------------------------------------------------------------------
# Registry: each family's cases call its real wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Case:
    name: str
    run: Callable[[], Any]
    ragged: bool = False       # a ragged shape: the sentinel run takes it


class Maker:
    """Tensors for the cases: uninitialised CPU tensors for the checker
    (only shapes, dtypes and int contents matter), random ones on the card
    for the sentinel run."""

    def __init__(self, device="cpu", seed: int = 0):
        self.device = torch.device(device)
        self.random = self.device.type == "cuda"
        self.gen = torch.Generator(device=self.device).manual_seed(seed) \
            if self.random else None

    def t(self, shape, dtype=torch.bfloat16, scale: float = 1.0):
        if not self.random:
            return torch.empty(shape, dtype=dtype, device=self.device)
        return (torch.randn(shape, generator=self.gen, device=self.device)
                * scale).to(dtype)

    def positive(self, shape, scale: float = 0.05):
        if not self.random:
            return torch.empty(shape, dtype=torch.float32, device=self.device)
        return torch.rand(shape, generator=self.gen,
                          device=self.device) * scale + scale / 10

    def codes(self, shape, dtype):
        if not self.random:
            return torch.empty(shape, dtype=dtype, device=self.device)
        lo, hi = (0, 256) if dtype == torch.uint8 else (-127, 128)
        return torch.randint(lo, hi, shape, generator=self.gen,
                             device=self.device).to(dtype)

    def ints(self, values):
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)


@dataclasses.dataclass
class KernelFamily:
    name: str
    build: Callable[[Maker], List[Case]]


_REGISTRY: Dict[str, KernelFamily] = {}


def register_kernel(name: str):
    """Decorator: register a builder ``build(make) -> [Case]``."""
    def deco(build):
        _REGISTRY[name] = KernelFamily(name, build)
        return build
    return deco


def registered_kernels() -> List[str]:
    return sorted(_REGISTRY)


def _capture(cases: Sequence[Case]) -> List[Tuple[str, LaunchRecord]]:
    out = []
    for case in cases:
        with capture_launches() as records:
            with torch.no_grad():
                case.run()
        for i, rec in enumerate(records):
            suffix = f"/{i}" if len(records) > 1 else ""
            out.append((case.name + suffix, rec))
    return out


def family_cases(name: str, full: bool = True
                 ) -> List[Tuple[str, LaunchRecord]]:
    """The recorded calls of family ``name``'s cases on the CPU: the
    representative shapes and, with ``full``, every FULL config's."""
    make = Maker("cpu")
    cases = list(_REGISTRY[name].build(make))
    if full:
        cases += full_config_cases(name, make)
    return _capture(cases)


def check_kernels(
    names: Optional[Sequence[str]] = None,
    *,
    target: str = "h100",
    full: bool = True,
    card: bool = False,
    stats: Optional[Dict[str, int]] = None,
) -> List[Finding]:
    """Run every registered contract; returns all findings (empty =
    pass).  ``card=True`` adds the describe and sentinel checks and
    raises when no CUDA device is present.  ``stats`` (a dict) gets the
    number of recorded calls under ``"cases"``."""
    if card:
        if not torch.cuda.is_available():
            raise RuntimeError("check_kernels(card=True) needs a CUDA "
                               "device")
        from repro_torch.kernels import _build

        _build.build_all()          # every source at once, if not current
    budget = SMEM_TARGET_BYTES[target]
    findings: List[Finding] = []
    n_cases = 0
    for name in (names if names is not None else registered_kernels()):
        try:
            cases = family_cases(name, full)
        except Exception as e:  # repro: allow(broad-except) a builder crash of ANY kind is reported as a contract failure, not swallowed
            findings.append(Finding(name, "<build>", "grid",
                                    f"builder raised {e!r}"))
            continue
        if not cases:
            findings.append(Finding(name, "<build>", "grid",
                                    "builder captured no launch"))
        n_cases += len(cases)
        for case, rec in cases:
            launches = geometry.model(rec)
            findings += check_record(name, case, rec, smem_block=budget,
                                     launches=launches)
            if card:
                findings += check_describe(name, case, rec, launches)
        if card:
            findings += sentinel(name)
    if stats is not None:
        stats["cases"] = n_cases
    return findings


def sentinel(name: str, device=None) -> List[Finding]:
    """Family ``name``'s ragged cases launched on the card over guarded
    outputs (see :func:`capture_launches`)."""
    dev = torch.device(device or "cuda")
    make = Maker(dev, seed=7)
    findings = []
    for case in _REGISTRY[name].build(make):
        if not case.ragged:
            continue
        records, found = [], []
        with capture_launches(records, launch=True, findings=found):
            with torch.no_grad():
                case.run()
        if not records:
            findings.append(Finding(name, case.name, "grid",
                                    "the sentinel run launched nothing"))
        for check, export, message in found:
            findings.append(Finding(name, f"{case.name} (sentinel)", check,
                                    f"{export}: {message}"))
    return findings


# ---------------------------------------------------------------------------
# The eight families: the JAX builders' representative shapes (plus the
# bodies the port adds: float32 SIMT, the split decodes, hd 256)
# ---------------------------------------------------------------------------

def _fa():
    from repro_torch.kernels import flash_attention as fa
    return fa


@register_kernel("flash_fwd")
def _flash_fwd_cases(make: Maker) -> List[Case]:
    fa = _fa()

    def run(b, s, h, kv, hd, window, dtype=torch.bfloat16):
        q = make.t((b, s, h, hd), dtype)
        k, v = make.t((b, s, kv, hd), dtype), make.t((b, s, kv, hd), dtype)
        return lambda: fa.flash_attention(q, k, v, window=window)

    return [
        # qwen2-0.5b GQA layout (14 heads / 2 KV)
        Case("gqa_s1024", run(1, 1024, 14, 2, 64, None)),
        # llama-7b-proxy MHA heads, a ragged last query tile
        Case("mha_s130_pad", run(1, 130, 8, 8, 128, None), ragged=True),
        # sliding window (griffin local-attention layers)
        Case("window_s512", run(1, 512, 4, 2, 64, 96)),
        # Griffin's head_dim 256 (one block an SM), ragged
        Case("hd256_s200", run(2, 200, 4, 1, 256, 128), ragged=True),
        Case("f32_s130", run(1, 130, 8, 4, 128, None, torch.float32),
             ragged=True),
        Case("f32_hd256_s70", run(1, 70, 2, 1, 256, None, torch.float32)),
    ]


def _decode_lens(b, s_max):
    return np.minimum(np.arange(1, b + 1) * (s_max // (b + 1) + 1), s_max)


@register_kernel("flash_decode")
def _flash_decode_cases(make: Maker) -> List[Case]:
    fa = _fa()

    def run(b, s_max, h, kv, hd, window, dtype=torch.bfloat16):
        q = make.t((b, 1, h, hd), dtype)
        kc = make.t((b, s_max, kv, hd), dtype)
        vc = make.t((b, s_max, kv, hd), dtype)
        lens = make.ints(_decode_lens(b, s_max))
        return lambda: fa.flash_decode_attention(q, kc, vc, lens,
                                                 window=window)

    return [
        # serving decode over the engine's dense cache
        Case("gqa_cache256", run(4, 256, 14, 2, 64, None)),
        # odd (non-tile-divisible) cache extent
        Case("odd_cache100", run(2, 100, 8, 8, 128, None), ragged=True),
        Case("window_cache512", run(2, 512, 4, 2, 64, 96)),
        # a long cache: every score split in use
        Case("splits_cache2000", run(2, 2000, 8, 2, 128, None)),
        Case("f32_odd_cache100", run(2, 100, 8, 8, 128, None, torch.float32),
             ragged=True),
    ]


def _paged_tables(alloc, bs):
    """Tables as ``paging.PagedCacheView.device_tables`` builds them:
    allocated rows first (row 0 is the null block), entries past a slot's
    count repeating its last row; lengths mid-way into each slot's last
    block."""
    b, max_b = len(alloc), max(alloc)
    tables = np.zeros((b, max_b), np.int32)
    lens = np.zeros((b,), np.int32)
    nxt = 1
    for slot, n in enumerate(alloc):
        rows = list(range(nxt, nxt + n))
        nxt += n
        tables[slot, :n] = rows
        tables[slot, n:] = rows[-1] if rows else 0
        lens[slot] = max(1, n * bs - bs // 2)
    return tables, lens


@register_kernel("paged_decode")
def _paged_decode_cases(make: Maker) -> List[Case]:
    fa = _fa()

    def run(b, n_pool, bs, kv, hd, h, alloc, dtype=torch.bfloat16):
        tables, lens = _paged_tables(alloc, bs)
        q = make.t((b, 1, h, hd), dtype)
        kp = make.t((n_pool, bs, kv, hd), dtype)
        vp = make.t((n_pool, bs, kv, hd), dtype)
        t, n = make.ints(tables), make.ints(lens)
        return lambda: fa.paged_flash_decode_attention(q, kp, vp, t, n)

    return [
        # mixed allocation: full, partial and single-block slots
        Case("gqa_pool32", run(4, 32, 16, 2, 64, 14, (6, 3, 1, 6)),
             ragged=True),
        # block_size 16 with a fully allocated slot
        Case("bs16_full", run(2, 16, 16, 8, 128, 8, (7, 2))),
        Case("f32_gqa_pool32", run(4, 32, 16, 2, 64, 14, (6, 3, 1, 6),
                                   torch.float32), ragged=True),
    ]


@register_kernel("paged_decode_quant")
def _paged_decode_quant_cases(make: Maker) -> List[Case]:
    fa = _fa()

    def run(b, n_pool, bs, kv, hd, h, alloc, fmt, qb, dtype=torch.bfloat16):
        tables, lens = _paged_tables(alloc, bs)
        q = make.t((b, 1, h, hd), dtype)
        code_dt, width = ((torch.uint8, hd // 2) if fmt == "nf4"
                          else (torch.int8, hd))
        lead = (n_pool, bs, kv)
        kc, vc = make.codes(lead + (width,), code_dt), \
            make.codes(lead + (width,), code_dt)
        nsb = -(-hd // qb)
        ks, vs = make.positive(lead + (nsb,)), make.positive(lead + (nsb,))
        t, n = make.ints(tables), make.ints(lens)
        return lambda: fa.paged_flash_decode_attention(
            q, kc, vc, t, n, kv_quant=fmt, k_scales=ks, v_scales=vs,
            quant_block=qb)

    alloc = (6, 3, 1, 6)
    return [
        # nf4 at the default block 64 (one scale block a row)
        Case("nf4_gqa_pool32", run(4, 32, 16, 2, 64, 14, alloc, "nf4", 64)),
        # a remainder scale block: hd 80 in blocks of 64
        Case("nf4_hd80_remainder", run(2, 16, 16, 4, 80, 8, (7, 2), "nf4",
                                       64), ragged=True),
        # int8 codes, a small quant block
        Case("int8_bs16", run(2, 16, 16, 8, 24, 8, (7, 2), "int8", 16),
             ragged=True),
        Case("f32_nf4_pool32", run(4, 32, 16, 2, 64, 14, alloc, "nf4", 64,
                                   torch.float32), ragged=True),
        Case("f32_int8_bs16", run(2, 16, 16, 8, 24, 8, (7, 2), "int8", 16,
                                  torch.float32)),
    ]


def _chain(make: Maker, d_in, d_out, dims_in, dims_out=None,
           dtype=torch.bfloat16):
    """A QuanTA adapter's stage tensors in ``dtype`` (identity plus
    noise)."""
    from repro_torch.core.quanta import QuantaAdapter

    gen = torch.Generator(device=make.device).manual_seed(0)
    ad = QuantaAdapter.create(gen, d_in, d_out, dims_in=dims_in,
                              dims_out=dims_out or dims_in,
                              device=make.device)
    return [t.to(dtype) for t in ad.tensors], tuple(dims_in), ad.pairs


@register_kernel("quanta_apply")
def _quanta_apply_cases(make: Maker) -> List[Case]:
    from repro_torch.core.peft import choose_dims
    from repro_torch.kernels.quanta_apply import quanta_apply

    def run(rows, d_in, d_out, dims_in, dims_out=None,
            dtype=torch.bfloat16):
        tensors, dims, pairs = _chain(make, d_in, d_out, dims_in, dims_out,
                                      dtype)
        x = make.t((rows, d_in), dtype)
        return lambda: quanta_apply(x, tensors, dims, pairs)

    wide_in, wide_out = choose_dims(2048, 4096, 3, "16-16-8")
    return [
        # qwen2 hidden (896 = 16*8*7)
        Case("qwen2_d896", run(512, 896, 896, (16, 8, 7))),
        # 4-axis scheme (paper N=4), rows not a multiple of the row tile
        Case("n4_d256_pad", run(100, 256, 256, (4, 4, 4, 4)), ragged=True),
        Case("f32_n4_d256", run(100, 256, 256, (4, 4, 4, 4),
                                dtype=torch.float32), ragged=True),
        # mamba2-1.3b's widening x_proj chain: the last stage streams
        Case("streamed_d2048x2", run(1100, 2048, 4096, wide_in, wide_out),
             ragged=True),
    ]


@register_kernel("quanta_linear")
def _quanta_linear_cases(make: Maker) -> List[Case]:
    from repro_torch.kernels.quanta_linear import quanta_linear

    def run(rows, d, dims, dtype=torch.bfloat16, shards=1, col=0):
        tensors, dims, pairs = _chain(make, d, d, dims, dtype=dtype)
        x = make.t((rows, d), dtype)
        w = make.t((d, d // shards), dtype, scale=d ** -0.5)
        return lambda: quanta_linear(x, w, tensors, dims, pairs, col)

    return [
        # wgmma prefill, a ragged last row tile
        Case("qwen2_d896", run(200, 896, (16, 8, 7)), ragged=True),
        # a column shard (tensor parallelism over `model`): the delta read
        # at the second of two column blocks, by its row stride
        Case("qwen2_d896_cols", run(200, 896, (16, 8, 7), shards=2,
                                    col=448), ragged=True),
        Case("d512_rows8_cols", run(8, 512, (8, 8, 8), shards=4, col=256)),
        Case("f32_d512_cols", run(100, 512, (8, 8, 8), torch.float32,
                                  shards=2, col=256), ragged=True),
        # split-K decode over 8 rows (wgmma N 8) and 40 (N 64)
        Case("d512_rows8", run(8, 512, (8, 8, 8))),
        Case("d512_rows40", run(40, 512, (8, 8, 8)), ragged=True),
        Case("f32_d512", run(100, 512, (8, 8, 8), torch.float32),
             ragged=True),
    ]


@register_kernel("quantized_matmul")
def _quantized_matmul_cases(make: Maker) -> List[Case]:
    from repro_torch.kernels.quantized_matmul import quantized_matmul

    def run(rows, d_in, d_out, fmt, bs, dtype=torch.bfloat16, norms=False):
        qw = _qweight(make, d_in, d_out, fmt, bs, dtype, norms)
        x = make.t((rows, d_in), dtype)
        return lambda: quantized_matmul(x, qw)

    return [
        # qwen2 hidden at the default nf4 block: the wgmma prefill body
        Case("nf4_d896", run(256, 896, 896, "nf4", 64)),
        # ragged everywhere: 100 rows, a ragged last scale block
        # (200 % 64), 136 columns; float32 SIMT
        Case("int8_remainder", run(100, 200, 136, "int8", 64, torch.float32),
             ragged=True),
        # row/col normalizers, 64 rows: the decode body (wgmma N 64)
        Case("nf4_colpad_norms", run(64, 256, 640, "nf4", 64, norms=True)),
        # a decode tick split over K, then the reduce
        Case("nf4_decode8_split", run(8, 4096, 1024, "nf4", 64),
             ragged=True),
        # few output tiles: the prefill body split over K
        Case("int8_prefill_split", run(200, 4096, 200, "int8", 32),
             ragged=True),
    ]


def _qweight(make, d_in, d_out, fmt, bs, dtype, norms=False):
    from repro_torch.core.quantize import QuantizedLinear

    rows = d_in // 2 if fmt == "nf4" else d_in
    packed = make.codes((rows, d_out),
                        torch.uint8 if fmt == "nf4" else torch.int8)
    scales = make.positive((-(-d_in // bs), d_out))
    row = make.positive((d_in,), 1.0) if norms else None
    col = make.positive((d_out,), 1.0) if norms else None
    return QuantizedLinear(packed, scales, fmt, bs, dtype, row, col)


@register_kernel("banked_gather")
def _banked_gather_cases(make: Maker) -> List[Case]:
    from repro_torch.kernels.banked_gather import (
        banked_lora_delta, banked_lora_linear,
    )

    def run(n_slots, seq, d_in, d_out, g, rank, fuse, dtype=torch.bfloat16):
        x = make.t((n_slots, seq, d_in), dtype)
        a = make.t((g + 1, d_in, rank), dtype, scale=d_in ** -0.5)
        b = make.t((g + 1, rank, d_out), dtype, scale=rank ** -0.5)
        ids = make.ints(np.arange(n_slots) % (g + 1))
        if fuse:
            w = make.t((d_in, d_out), dtype, scale=d_in ** -0.5)
            return lambda: banked_lora_linear(x, w, a, b, ids, scale=2.0)
        return lambda: banked_lora_delta(x, a, b, ids, scale=2.0)

    return [
        # decode tick at qwen2-0.5b hidden, fused base and gather
        Case("fused_decode_d896", run(8, 1, 896, 896, 4, 8, True)),
        # prefill wave, delta only (a quantized base keeps its own kernel)
        Case("delta_prefill_s64", run(4, 64, 896, 896, 4, 8, False)),
        # column remainder: 136 columns, float32 SIMT
        Case("fused_remainder", run(4, 1, 200, 136, 2, 4, True,
                                    torch.float32), ragged=True),
        # wgmma prefill, ragged rows and columns
        Case("fused_prefill_s40", run(4, 40, 512, 264, 3, 16, True),
             ragged=True),
        # the decode body at 40 rows (wgmma N 64)
        Case("fused_decode_rows40", run(5, 8, 256, 136, 2, 8, True),
             ragged=True),
    ]


# ---------------------------------------------------------------------------
# Every FULL config's kernel shapes: 3072 prefill rows (8 x 384), 8 decode
# rows, bf16, the shapes chip_smoke.py's check phase gives each kernel
# ---------------------------------------------------------------------------

FULL_PREFILL = (8, 384)
FULL_DECODE_SLOTS = 8
FULL_CACHE = 512
FULL_RANK = 16


def _full_archs() -> Tuple[str, ...]:
    from repro_torch.configs import ARCH_IDS

    return ARCH_IDS + ("llama2-7b-proxy",)


def _adapted(cfg) -> Dict[str, Tuple[int, int]]:
    """The QuanTA-adapted projections: q_proj and v_proj (Griffin also
    rec_proj; Mamba2 x_proj and out_proj)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        di = cfg.ssm_expand * d
        return {"x_proj": (d, di), "out_proj": (di, d)}
    out = {"q_proj": (d, cfg.n_heads * cfg.head_dim),
           "v_proj": (d, cfg.n_kv_heads * cfg.head_dim)}
    if cfg.family == "hybrid":
        out["rec_proj"] = (d, cfg.lru_width or d)
    return out


def _projections(cfg) -> Dict[str, Tuple[int, int]]:
    """Every projection a quantized base packs."""
    out = dict(_adapted(cfg))
    if cfg.family != "ssm":
        out["o_proj"] = (cfg.n_heads * cfg.head_dim, cfg.d_model)
        if cfg.d_ff:
            out["up_proj"] = (cfg.d_model, cfg.d_ff)
            out["down_proj"] = (cfg.d_ff, cfg.d_model)
    shapes = {}
    for name, shape in out.items():
        shapes.setdefault(shape, name)
    return {name: shape for shape, name in shapes.items()}


def full_config_cases(family: str, make: Maker) -> List[Case]:
    """Family ``family``'s cases at every FULL config's shapes."""
    from repro_torch.configs import get_config, get_peft
    from repro_torch.core.peft import choose_dims
    from repro_torch.kernels.banked_gather import banked_lora_linear
    from repro_torch.kernels.quanta_apply import quanta_apply
    from repro_torch.kernels.quanta_linear import quanta_linear
    from repro_torch.kernels.quantized_matmul import quantized_matmul

    fa = _fa()
    bf = torch.bfloat16
    cases: List[Case] = []
    rows_of = (("prefill", FULL_PREFILL[0] * FULL_PREFILL[1]),
               ("decode", FULL_DECODE_SLOTS))
    for arch in _full_archs():
        cfg = get_config(arch)
        attn = cfg.family != "ssm"
        decodes = attn and cfg.family != "hybrid"
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        window = (cfg.local_window if cfg.family == "hybrid"
                  else cfg.sliding_window)
        tag = f"{arch}"

        if family == "flash_fwd" and attn:
            b, s = FULL_PREFILL
            q = make.t((b, s, h, hd), bf)
            k, v = make.t((b, s, kv, hd), bf), make.t((b, s, kv, hd), bf)
            cases.append(Case(f"{tag}/prefill",
                              lambda q=q, k=k, v=v, w=window:
                              fa.flash_attention(q, k, v, window=w)))
        if family in ("flash_decode", "paged_decode",
                      "paged_decode_quant") and decodes:
            b, bs = FULL_DECODE_SLOTS, cfg.kv_block_size
            lens = np.linspace(1, FULL_CACHE, b).astype(np.int32)
            q = make.t((b, 1, h, hd), bf)
            if family == "flash_decode":
                kc = make.t((b, FULL_CACHE, kv, hd), bf)
                cases.append(Case(f"{tag}/decode",
                                  lambda q=q, kc=kc, n=make.ints(lens),
                                  w=window: fa.flash_decode_attention(
                                      q, kc, kc, n, window=w)))
            else:
                n_b = FULL_CACHE // bs
                alloc = [max(1, -(-int(n) // bs)) for n in lens]
                tables, _ = _paged_tables(alloc, bs)
                tables = np.pad(tables, ((0, 0), (0, n_b - tables.shape[1])),
                                mode="edge")
                n_pool = 1 + sum(alloc)
                t, n = make.ints(tables), make.ints(lens)
                if family == "paged_decode":
                    pool = make.t((n_pool, bs, kv, hd), bf)
                    cases.append(Case(
                        f"{tag}/decode",
                        lambda q=q, p=pool, t=t, n=n, w=window:
                        fa.paged_flash_decode_attention(q, p, p, t, n,
                                                        window=w)))
                else:
                    qb = cfg.quant_block_size
                    codes = make.codes((n_pool, bs, kv, hd // 2), torch.uint8)
                    sc = make.positive((n_pool, bs, kv, -(-hd // qb)))
                    cases.append(Case(
                        f"{tag}/decode_nf4",
                        lambda q=q, c=codes, s=sc, t=t, n=n, qb=qb, w=window:
                        fa.paged_flash_decode_attention(
                            q, c, c, t, n, kv_quant="nf4", k_scales=s,
                            v_scales=s, quant_block=qb, window=w)))
        if family in ("quanta_apply", "quanta_linear"):
            n_axes = get_peft(arch).n_axes
            for proj, (d_in, d_out) in _adapted(cfg).items():
                dims_in, dims_out = choose_dims(d_in, d_out, n_axes,
                                                cfg.quanta_scheme)
                tensors, dims, pairs = _chain(make, d_in, d_out, dims_in,
                                              dims_out)
                for phase, rows in rows_of:
                    x = make.t((rows, d_in), bf)
                    name = f"{tag}/{proj}/{phase}"
                    if family == "quanta_apply":
                        cases.append(Case(name, lambda x=x, t=tensors,
                                          d=dims, p=pairs:
                                          quanta_apply(x, t, d, p)))
                    else:
                        w = make.t((d_in, d_out), bf)
                        cases.append(Case(name, lambda x=x, w=w, t=tensors,
                                          d=dims, p=pairs:
                                          quanta_linear(x, w, t, d, p)))
        if family == "quantized_matmul":
            for proj, (d_in, d_out) in _projections(cfg).items():
                qw = _qweight(make, d_in, d_out, "nf4",
                              cfg.quant_block_size, bf)
                for phase, rows in rows_of:
                    x = make.t((rows, d_in), bf)
                    cases.append(Case(f"{tag}/{proj}/{phase}",
                                      lambda x=x, qw=qw:
                                      quantized_matmul(x, qw)))
        if family == "banked_gather":
            for proj, (d_in, d_out) in _adapted(cfg).items():
                a = make.t((5, d_in, FULL_RANK), bf)
                b = make.t((5, FULL_RANK, d_out), bf)
                w = make.t((d_in, d_out), bf)
                for phase, (n_slots, seq) in (("prefill", FULL_PREFILL),
                                              ("decode",
                                               (FULL_DECODE_SLOTS, 1))):
                    x = make.t((n_slots, seq, d_in), bf)
                    ids = make.ints(np.arange(n_slots) % 5)
                    cases.append(Case(f"{tag}/{proj}/{phase}",
                                      lambda x=x, w=w, a=a, b=b, i=ids:
                                      banked_lora_linear(x, w, a, b, i,
                                                         scale=2.0)))
    return cases
