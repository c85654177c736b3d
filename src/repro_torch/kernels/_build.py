"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, for
``sm_90a``, with a plain C interface (no PyTorch headers, so one source
builds in seconds).  ``<hash>`` covers the source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source or header rebuilds and
an unchanged one is loaded as it is.  Nothing
here runs at import: the CPU tests import every module on a machine with
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "nvcc_path", "build", "load",
           "build_all", "build_log", "dtype_code", "stream_ptr", "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/kernels (the package lives at <checkout>/src/repro_torch)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quanta_apply", "quanta_linear", "flash_attention",
           "quantized_matmul", "banked_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}

# dtype codes of the C entry points
_DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(dtype) -> int:
    code = _DTYPE_CODES.get(str(dtype))
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")
    return code


def stream_ptr() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, as the C entry points take it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize does not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the shared headers a source may include
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for one source unless its library is current."""
    out = _target(name)
    if out.exists():
        return None
    cmd = [nvcc_path(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(BUILD_DIR / f"{name}.log", "w")
    try:
        proc = subprocess.Popen(
            [*cmd, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
    except OSError:
        log.close()
        raise
    proc.repro_files = (tmp, out, log)  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    tmp, out, log = proc.repro_files  # type: ignore[attr-defined]
    rc = proc.wait()
    log.close()
    if rc != 0:
        text = (BUILD_DIR / f"{name}.log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Build every source at once (one ``nvcc`` each, all started
    together); returns the wall seconds it took."""
    t0 = time.monotonic()
    names = list(names)
    procs: Dict[str, Optional[subprocess.Popen]] = {}
    try:
        for n in names:
            procs[n] = _start(n)
        for n in names:
            _finish(n, procs[n])
    finally:
        for p in procs.values():
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    return time.monotonic() - t0


def build(name: str) -> Path:
    _finish(name, _start(name))
    return _target(name)


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said for ``name`` (empty when the library
    came from an earlier build)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib
