"""Checkpoint store (port of ``repro/checkpoint/store.py``), in the JAX
package's on-disk format, so that either package restores what the other
wrote.

Layout::

    <dir>/step_000001230/
        manifest.json        # {"step", "leaves": [{"path", "file",
                             #   "shape", "dtype", "crc32"}, ...]}
        leaf_00000.npy ...   # one array per leaf
    <dir>/step_000001230.tmp_<pid>/   (during write; atomic rename commits)

* **atomic**: a checkpoint directory appears only after ``os.rename``; a
  crashed save leaves only a ``.tmp_`` directory, removed by the next
  save, which ``latest_step`` never reports.
* **verified**: every leaf carries a crc32 of its stored bytes;
  ``restore`` re-hashes each one and raises ``IOError`` on a mismatch.
* **async**: ``AsyncCheckpointer.save`` copies every leaf to the host on
  the caller's thread, so the trainer may change its tensors right after,
  and writes the files on one worker thread.
* **the JAX package's leaves**: :func:`tree_flatten_with_paths` orders
  and names the leaves as ``jax.tree_util.tree_flatten_with_path`` does
  for the JAX package's trees: dataclass fields as ``.<name>`` in
  declaration order, dict keys sorted, sequence items by index, ``None``
  no leaf, static fields (``QuantaAdapter.dims_in``, ``AdapterSet.specs``,
  a quantized weight's ``fmt``) no leaf.  The port's two step counters
  (``TrainState.step``, ``AdamWState.step``: Python ints, named in their
  class's ``int_leaves``) are stored as 0-d int32 leaves, as the JAX
  package holds them, and come back as ints.  bf16 leaves are stored as
  uint16 under the tag ``"bfloat16"``.

``restore`` rebuilds the template's structure; the template may be a
tree of ``meta`` tensors (``models.param_specs``, ``attach`` and
``TrainState.create`` on ``meta``: the port's ``jax.eval_shape``).  Each
leaf goes to its template leaf's device, or to ``device`` where the
template leaf is on ``meta``, and else to the card: never to the CPU
unless the caller asks.  ``restore_resharded`` places every leaf on one
``torch.device``, or as DTensors on a ``DeviceMesh`` by a tree of
``launch.shardings`` specs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import default_device

__all__ = [
    "save", "restore", "restore_resharded", "latest_step",
    "AsyncCheckpointer", "tree_flatten_with_paths",
]

_MANIFEST = "manifest.json"


# ---------------------------------------------------------------------------
# The JAX package's flattening order and key paths
# ---------------------------------------------------------------------------

def _int_leaves(node) -> Tuple[str, ...]:
    return tuple(getattr(node, "int_leaves", ()))


def _is_node(v) -> bool:
    """A tensor, a dict, a tuple or list holding a node, or a dataclass
    with a node field or an int leaf: anything that holds leaves."""
    if isinstance(v, (torch.Tensor, dict)):
        return True
    if isinstance(v, (tuple, list)):
        return any(_is_node(e) for e in v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return bool(_int_leaves(v)) or any(
            _is_node(getattr(v, f.name)) for f in dataclasses.fields(v))
    return False


def _walk(fn: Callable[[str, Any], Any], node, path: str):
    """``node`` rebuilt with ``fn(path, leaf)`` at every leaf, ``fn``
    called in the JAX package's flattening order.  A leaf is a tensor or
    an int leaf of a dataclass; dicts keep their own key order."""
    if isinstance(node, torch.Tensor):
        return fn(path, node)
    if isinstance(node, dict):
        out = {k: _walk(fn, node[k], f"{path}/{k}" if path else str(k))
               for k in sorted(node)}
        return {k: out[k] for k in node}
    if isinstance(node, (tuple, list)):
        if not _is_node(node):
            return node
        items = [_walk(fn, e, f"{path}/{i}" if path else str(i))
                 for i, e in enumerate(node)]
        return type(node)(items)
    if dataclasses.is_dataclass(node) and _is_node(node):
        ints, new = _int_leaves(node), {}
        for f in dataclasses.fields(node):
            v, p = getattr(node, f.name), f"{path}/.{f.name}"
            if f.name in ints:
                new[f.name] = fn(p, v)
            elif _is_node(v):
                new[f.name] = _walk(fn, v, p)
        return dataclasses.replace(node, **new)
    return node                    # None and static values: no leaf


def tree_flatten_with_paths(tree: Any) -> Tuple[List[str], List[Any]]:
    """The leaves of ``tree`` and their key paths, in the order and under
    the names the JAX store gives the JAX package's counterpart of
    ``tree`` (``.params/embed/tokens``,
    ``.peft/.tree/layers/attn/q_proj/.tensors/0``, ``.opt_state/.step``,
    ``.step``).  Int leaves come as Python ints."""
    paths: List[str] = []
    leaves: List[Any] = []

    def take(path, leaf):
        paths.append(path.lstrip("/"))
        leaves.append(leaf)
        return leaf

    _walk(take, tree, "")
    return paths, leaves


def _map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf (tensor or int leaf) replaced by
    ``fn(leaf)``, called in the flattening order."""
    return _walk(lambda _, leaf: fn(leaf), tree, "")


# ---------------------------------------------------------------------------
# Arrays on disk
# ---------------------------------------------------------------------------

def _stored(leaf) -> Tuple[np.ndarray, str, Tuple[int, ...]]:
    """The array written for ``leaf``, its dtype tag and its shape."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf, dtype=np.int32)        # a step counter
        return arr, str(arr.dtype), arr.shape
    t = leaf.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).numpy().view(np.uint16), "bfloat16",
                tuple(t.shape))
    arr = t.numpy()
    return arr, str(arr.dtype), arr.shape


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (no copy when contiguous)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic save.  Returns the committed directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:012d}")
    tmp = f"{final}.tmp_{os.getpid()}"
    # stale tmp directories of crashed saves
    for name in os.listdir(directory):
        if ".tmp_" in name:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)

    paths, leaves = tree_flatten_with_paths(tree)
    manifest: Dict[str, Any] = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        stored, dtype_tag, shape = _stored(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), stored, allow_pickle=False)
        manifest["leaves"].append({
            "path": path,
            "file": fname,
            "shape": list(shape),
            "dtype": dtype_tag,
            "crc32": _crc32(stored),
        })
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step under ``directory`` (``.tmp_``
    directories and directories without a manifest are not committed), or
    None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and ".tmp_" not in name
        and os.path.exists(os.path.join(directory, name, _MANIFEST))
    ]
    return max(steps) if steps else None


def _load_leaves(ckpt_dir: str) -> List[Tuple[np.ndarray, str]]:
    """Every leaf's array (crc verified) and its dtype tag."""
    with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = []
    for entry in manifest["leaves"]:
        stored = np.load(os.path.join(ckpt_dir, entry["file"]),
                         allow_pickle=False)
        crc = _crc32(stored)
        if crc != entry["crc32"]:
            raise IOError(
                f"checkpoint corruption: {entry['path']} crc {crc} != "
                f"{entry['crc32']}"
            )
        leaves.append((stored.reshape(entry["shape"]), entry["dtype"]))
    return leaves


def _tensor(arr: np.ndarray, dtype_tag: str, device) -> torch.Tensor:
    if dtype_tag == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _restore(directory: str, step: int, template: Any,
             place: Callable[[torch.Tensor], torch.device]) -> Any:
    ckpt_dir = os.path.join(directory, f"step_{step:012d}")
    leaves = _load_leaves(ckpt_dir)
    _, t_leaves = tree_flatten_with_paths(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template {len(t_leaves)}"
        )
    it: Iterator = iter(leaves)

    def fill(t_leaf):
        arr, tag = next(it)
        if not isinstance(t_leaf, torch.Tensor):
            return int(arr)                     # a step counter
        return _tensor(arr, tag, place(t_leaf))

    return _map_leaves(fill, template)


def restore(directory: str, step: int, template: Any, *,
            device=None) -> Any:
    """Restore into the structure of ``template`` (verifies hashes).  A
    leaf goes to its template leaf's device; where that is ``meta``, to
    ``device``, else to the card (raises when there is none)."""
    meta_dev: List[torch.device] = []

    def place(t_leaf: torch.Tensor) -> torch.device:
        if t_leaf.device.type != "meta":
            return t_leaf.device
        if not meta_dev:
            meta_dev.append(default_device(device))
        return meta_dev[0]

    return _restore(directory, step, template, place)


def restore_resharded(directory: str, step: int, template: Any,
                      placement: Any, specs: Any = None) -> Any:
    """Elastic restore onto a new placement, whatever saved it.

    ``placement`` is one ``torch.device`` (or a string naming one): every
    leaf goes there.  Or it is a ``DeviceMesh`` with ``specs``, a tree of
    ``launch.shardings`` specs mirroring ``template`` (``param_shardings``,
    ``state_shardings``, ...): every rank reads the whole leaves onto its
    device and keeps its shard, each leaf a DTensor with the spec's
    placements.  Anything else raises ``TypeError``."""
    if isinstance(placement, (torch.device, str)):
        dev = default_device(placement)
        return _restore(directory, step, template, lambda _: dev)
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(placement, DeviceMesh) or specs is None:
        raise TypeError(
            f"restore_resharded onto {type(placement).__name__}"
            f"{' without specs' if isinstance(placement, DeviceMesh) else ''}"
            ": pass a torch.device, or a DeviceMesh with a spec tree")
    from repro_torch.launch.shardings import distribute_tree

    kind = placement.device_type
    dev = default_device(kind if kind != "cuda" else None)
    tree = _restore(directory, step, template, lambda _: dev)
    return distribute_tree(tree, placement, specs)


class AsyncCheckpointer:
    """Background-thread checkpointing off the training critical path.

    ``timings[step]`` holds each save's seconds: ``snapshot_s`` (the
    host copy on the caller's thread), ``wait_s`` (the caller waiting for
    the previous save), ``write_s`` (the files, on the worker) and
    ``bytes`` (the leaves' bytes written)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()
        self.timings: Dict[int, Dict[str, float]] = {}

    def save(self, step: int, tree: Any) -> Future:
        # Snapshot on the caller thread (device->host copy) so that the
        # trainer may change its tensors in place right after.
        t0 = time.perf_counter()
        on_card: set = set()

        def snap(leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if leaf.is_cuda:
                on_card.add(leaf.device)
            return leaf.detach().to("cpu", copy=True)

        host_tree = _map_leaves(snap, tree)
        for dev in on_card:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        self.wait()  # keep at most one outstanding save
        timing = self.timings[step] = dict(snapshot_s=t1 - t0,
                                           wait_s=time.perf_counter() - t1)

        def _do():
            t = time.perf_counter()
            path = save(self.directory, step, host_tree)
            timing["write_s"] = time.perf_counter() - t
            timing["bytes"] = sum(
                leaf.numel() * leaf.element_size() if isinstance(
                    leaf, torch.Tensor) else 4
                for leaf in tree_flatten_with_paths(host_tree)[1])
            self._gc()
            return path

        with self._lock:
            self._pending = self._pool.submit(_do)
            return self._pending

    def wait(self):
        with self._lock:
            pending = self._pending
        if pending is not None:
            pending.result()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and ".tmp_" not in n
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:012d}"),
                ignore_errors=True,
            )

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)
