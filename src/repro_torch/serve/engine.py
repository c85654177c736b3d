"""Continuous-batching serving engine over a dense or a paged cache (port
of ``repro/serve/engine.py``), on one device or a mesh.

* A fixed ``n_slots`` decode batch; each slot owns a stripe of the dense
  KV cache ``(L, n_slots, max_len, KV, hd)``, or (``cache="paged"``) the
  pool blocks its block table names (``serve/paging.py``): blocks are
  reserved at admission, allocated on append, freed on eviction, and when
  the pool runs dry mid-decode a slot is preempted (recompute: the
  request goes back to the queue front and later re-prefills ``prompt +
  output``).
* Admission by prefill wave (``admission="prefill"``, the default): queued
  prompts are right-padded to a length bucketed to a multiple of
  ``seq_bucket``, prefilled in one call over ``n_slots`` rows, and their
  cache stripes scattered into free slots (``_admit`` ->
  ``_admit_prefill`` -> ``_insert_wave``).
* Chunked prefill (``prefill_chunk=N``, for a model with a
  ``prefill_chunk`` step; others, Griffin among them, are admitted by
  waves, as in the JAX engine): a prompt longer than ``N`` tokens is
  prefilled one ``N``-token chunk a tick into a dense staging cache
  (``_start_chunked`` / ``_step_chunked``), decode ticks running in
  between; the finished staging cache lands through the same
  ``insert_cache`` scatter as a wave.  One chunked admission at a time.
* Replay admission (``admission="replay"``): prompts step token by token
  through the decode tick itself, batched across the wave, each step
  with the wave's own active mask.  Dense caches only.  ``"auto"`` (the
  default) admits by prefill wave, and by replay a model with a
  frontend (pixtral, served text only), which cannot take
  ``admission="prefill"``; an audio model (musicgen: frame embeddings,
  no tokens) takes no engine.
* One fused decode tick for every slot (``dispatch_decode``): the decode
  step, the active-slot merge of the slot-state leaves (``len``, and a
  recurrent model's O(1) states), the greedy sample and
  the token merge ``where(fresh, host, chain)`` (``chain``: the previous
  tick's sampled tokens, which stay on the device).  Its inputs live in
  static device buffers -- tokens ``(B, 1)``, the active and fresh masks,
  the tenant ids ``(B,)`` and (paged) the block tables -- refreshed from
  pinned host memory with ``non_blocking=True`` copies.  On a CUDA engine
  the first tick runs eagerly on a side stream (the warm-up PyTorch's
  graph recipe asks for) and then one ``torch.cuda.CUDAGraph`` is
  captured over those buffers; every later tick copies its inputs in and
  replays it.  On the CPU nothing is captured: the same step runs eagerly
  over the same buffers.  A capture that fails raises; nothing carries on
  eagerly on the card.  Each tick's sampled tokens land through one
  device-to-host copy into a pinned buffer with its own event, queued
  right after the tick.
* Slots free on EOS, token budget or ``max_len``; the queue backfills on
  the next tick.

The capture guard (``repro_torch.analysis.sanitize.CompileGuard``,
``engine.compile_guard``): the decode tick is registered with the bound
of ``compilation_bounds()`` (one graph per engine) and ``step()`` asserts
it every tick under ``REPRO_SANITIZE=1``.  Before each replay the engine
checks on the host that every buffer the graph captured -- cache leaves,
static inputs, the table buffer -- keeps its storage, and raises when one
has moved.  A replay calls no kernel wrapper, so the launches each
wrapper counted while the graph was captured are added to its counter at
every replay (``kernels.launch_counts()`` stays true).

Serving the adapter-attached model (``peft=``, an ``AdapterSet``) is
numerically the merged model's (``core.peft.merge_all``).
``adapters=`` (a ``core.bank.AdapterBank`` or a
``serve.adapter_pool.AdapterPool``) serves many tenants over one base:
``submit(req, adapter="name")`` names each request's tenant (``None`` the
base model), the engine keeps a per-slot global id (0 for pad rows and
free slots) and hands the batch's ids to every model call.  With a pool,
admission pins the request's tenant (loading it, maybe evicting an idle
one) as its last check and defers the request when no row can be freed;
freeing or preempting a slot unpins.  A pool swaps rows and id maps in
place, so the captured graph sees them.  ``cfg.peft_backend="pallas"``
routes QuanTA (and quantized projections) through the hand-written
kernels and ``cfg.attn_backend="pallas"`` attention through the flash
kernels.  ``base_quant="nf4"|"int8"`` packs every projection into a
blockwise ``QuantizedLinear`` at construction (the QLoRA pattern:
adapters stay full precision on top); ``kv_quant`` cross-checks
``cfg.kv_quant``, which makes the model store NF4/int8 codes in the
paged pools (the fake-quantized round trip in a dense cache).  The
decode step updates the cache in place: the stripes of inactive slots
hold entries past their length that every reader masks, and their pool
writes land in the null block.

Front-end seams (``serve/frontend.py``): ``validate()`` and
``_admit(queue=, chunk=)`` (admission from the SLA scheduler's ready
view, the chunk cadence left to its interleave policy), ``requeue_hook``
and ``victim_hook`` (preemption into the class queues, SLA-aware
victims), ``_fresh`` (slots whose next token admission wrote on the
host), ``clock``, ``tick_hist``, the per-class TTFT histograms
(``ttft_hists``, ``ttft_all()``) and ``queue_depths()``.

Sharded serving (``mesh=``, a ``DeviceMesh`` from ``launch.mesh``, one
rank a device, over the whole process group).  Every rank runs the same
scheduler on the same requests (submit each request on every rank), so
host state -- queues, slots, block tables -- is the same everywhere.

* Placement: the cache by ``launch.shardings.cache_shardings`` on the
  data axes (the slot axis, or a paged pool's block axis, over them); a
  paged pool is cut into one arena a data shard
  (``PagedCacheView(data_shards=)``).  Adapters and banks are replicated
  (a pool through ``AdapterPool.place``).
* Tensor parallelism over `model`, for the dense family (a
  ``Transformer`` that is not MoE; its frontend models too): each rank
  holds its shards of the params by the JAX decode rules
  (``launch.shardings.local_params`` of ``param_shardings(decode=True)``:
  q/k/v and gate/up column-parallel, o_proj and down_proj row-parallel,
  the table on d_model, an untied ``lm_head`` on the vocab) and runs the
  forward Megatron style on plain local tensors, with explicit
  collectives on the `model` sub-group (``models/tensor_parallel.py``);
  every kernel runs on the rank's shards.  The cache holds the rank's KV
  heads: the engine puts `model` on the KV-head axis of every KV leaf
  itself, where the JAX ``cache_shardings`` gives it to the last dim
  that divides (head_dim), because the whole-head kernels need the heads
  local.  ``model`` must divide ``n_heads``, ``n_kv_heads``, ``d_ff`` and
  ``d_model``, and the adapters be LoRA or QuanTA; anything else raises
  at construction (the head_dim split, and DoRA, DoTA and KronA on
  shards, are ROADMAP items).  Griffin, Mamba2 and the MoE branch keep
  the `model` axis replicated: its ranks repeat their data shard's work
  (``stats["model_shards"]`` reads 1 for them, ``m`` for the dense
  family).  ``stats`` byte gauges count what this rank holds.
* Work: a data rank prefills the wave rows of its own slots and runs a
  chunked admission only when the slot is its own; it decodes its own
  slots (``n_slots / dp`` rows) on its own cache shard, and the paged
  decode runs on its arena alone (the mesh reaches attention only when
  the pool has more than one arena: ``attention.local_paged_decode``,
  kernel 5 or 6 per arena).  The first tokens of an admission and each
  tick's sampled tokens are shared over the mesh (one ``all_reduce``
  each, one rank of each data shard contributing), so every rank lands
  every slot's token; ``dispatch_decode`` returns this rank's rows of
  the logits.
* Graph ticks: on a world of one the tick is captured as one CUDA graph
  as without a mesh; with more ranks the tick runs eagerly (its token
  share is a collective outside the graph).
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.analysis import sanitize
from repro_torch.core.adapters import tree_nbytes, unsharded_method
from repro_torch.core.bank import AdapterBank
from repro_torch.core.peft import flatten_paths
from repro_torch.core.quantize import quantize_params
from repro_torch.kernels.dispatch import default_device, upload
from repro_torch.models.common import (
    PagedCacheLeafSpec, insert_cache_slots, merge_cache_slots,
    reset_cache_slots,
)
from repro_torch.models.tensor_parallel import ONE, model_group
from repro_torch.models.transformer import Transformer
from repro_torch.serve.adapter_pool import AdapterPool
from repro_torch.serve.metrics import LatencyHistogram
from repro_torch.serve.paging import PagedCacheView

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # the bank tenant to decode with (None = the base model; engines built
    # with adapters= only)
    adapter: Optional[str] = None
    # SLA scheduling (serve/scheduler.py): the arrival stamp (the engine's
    # clock at submit when None; an open-loop harness sets future
    # arrivals) and the latency class.  Both survive preemption: the
    # requeue reuses this very object.
    arrival_time: Optional[float] = None
    latency_class: str = "interactive"
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_time: Optional[float] = None


class _Landing:
    """One tick's sampled tokens on their way to the host: a pinned
    buffer and the event recorded after its copy (CPU: the tokens)."""

    def __init__(self, sampled: torch.Tensor):
        if sampled.is_cuda:
            self._host = torch.empty(sampled.shape, dtype=sampled.dtype,
                                     pin_memory=True)
            self._host.copy_(sampled, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = sampled.clone(), None

    def tokens(self) -> np.ndarray:
        """The ``(B,)`` tokens, waiting for the copy when it has not run."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()[:, 0]


@functools.lru_cache(maxsize=None)
def _warmup_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device for every engine's warm-up tick: cuBLAS
    keeps a workspace for each stream it has run on, for the life of the
    process, so a new stream per engine would hold one more each time."""
    return torch.cuda.Stream(device)


class _DecodeGraph:
    """The decode tick as a captured CUDA graph over static buffers.

    ``body()`` runs one tick on the engine's static buffers and returns its
    outputs.  On a CUDA device the first call runs it eagerly on a side
    stream, then captures one graph of it (in the graph's own memory
    pool); every later call replays the graph.  On the CPU every call runs
    the body.  ``_cache_size()`` is the number of graphs captured, which
    the capture guard holds to its bound.  ``buffers()`` lists the tensors
    the graph reads and writes: their storage is recorded at the first
    call and checked before every later one.  Setting ``eager`` runs
    every later call's body without the graph, over the same buffers (the
    twin a graph tick is held against).
    """

    def __init__(self, body: Callable[[], Any],
                 buffers: Callable[[], Dict[str, torch.Tensor]],
                 device: torch.device):
        self.body = body
        self.buffers = buffers
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        self.eager = False
        self.captures = 0
        self.capture_s = 0.0          # wall time of the warm-up and capture
        self._ptrs: Optional[Dict[str, int]] = None
        self._launches: Dict[str, int] = {}

    def _cache_size(self) -> int:
        return self.captures

    def _check_buffers(self) -> None:
        ptrs = {k: t.data_ptr() for k, t in self.buffers().items()}
        if self._ptrs is None:
            self._ptrs = ptrs
            return
        moved = sorted(k for k in ptrs if ptrs[k] != self._ptrs.get(k))
        if moved:
            raise RuntimeError(
                f"decode tick buffers {moved} moved since the graph was "
                "captured: the replay would read and write their old "
                "storage; update them in place")

    def __call__(self):
        self._check_buffers()
        if self.device.type != "cuda" or self.eager:
            return self.body()
        if self.graph is not None:
            self.graph.replay()
            for name, n in self._launches.items():
                kernels.KERNELS[name].launches += n
            return self.out
        # warm-up on a side stream (cuBLAS handles, shared-memory grants,
        # TMA encoders and cached constants are all set up here, outside
        # the capture), then capture
        t0 = time.monotonic()
        main = torch.cuda.current_stream(self.device)
        side = _warmup_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.body()
        main.wait_stream(side)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # a collection during the capture could free another engine's
        # graph, whose destruction the capturing stream refuses (the
        # capture is then lost): collect first, and not during it
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self.out = self.body()
        except Exception as e:
            raise RuntimeError(
                "capturing the decode tick as a CUDA graph failed; the "
                "engine does not fall back to eager ticks on the card"
            ) from e
        finally:
            if collecting:
                gc.enable()
            during = kernels.launch_counts()
            for name, n in before.items():
                kernels.KERNELS[name].launches = n
        self._launches = {k: during[k] - before[k] for k in before
                          if during[k] != before[k]}
        self.graph = graph
        self.captures += 1
        sanitize.record_capture()
        self.capture_s = time.monotonic() - t0
        return out


class ServingEngine:
    def __init__(
        self,
        model,
        params,
        peft=None,
        *,
        adapters=None,
        n_slots: int = 4,
        max_len: int = 256,
        admission: str = "auto",
        seq_bucket: int = 16,
        cache: str = "dense",
        block_size: int = 16,
        n_blocks: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        mesh=None,
        base_quant: Optional[str] = None,
        kv_quant: Optional[str] = None,
        device=None,
    ):
        if adapters is not None:
            if not isinstance(adapters, (AdapterBank, AdapterPool)):
                raise TypeError(
                    f"adapters= takes an AdapterBank or an AdapterPool, got "
                    f"{type(adapters).__name__}")
            if peft is not None:
                raise ValueError(
                    "pass either peft= (one adapter set for every request) "
                    "or adapters= (an AdapterBank with per-request "
                    "selection)")
        if cache not in ("dense", "paged"):
            raise ValueError(f"unknown cache mode {cache!r}")
        if model.cfg.frontend == "audio_tokens":
            # the JAX engine fails at its first step (KeyError 'embeds')
            raise ValueError(
                f"model {model.cfg.name!r} reads frame embeddings "
                f"(audio_tokens frontend) and the engine feeds tokens: "
                f"drive it through its own prefill and decode_step")
        self.device = default_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model on {model.device}, engine asked for {self.device}"
            )
        self._mesh_layout(mesh, n_slots, model)
        self.model = model
        self.cfg = model.cfg
        # frozen-base quantization: every projection packed once here;
        # already quantized leaves are kept
        self.base_quant = base_quant
        if self._tp.size > 1:
            self._check_tp(adapters if adapters is not None else peft)
            from repro_torch.launch.shardings import local_params

            # this rank's shards, packed from them under base_quant
            params = local_params(self.cfg, mesh, params, self.device,
                                  base_quant,
                                  block_size=self.cfg.quant_block_size)
        elif base_quant is not None:
            params = quantize_params(params, base_quant,
                                     block_size=self.cfg.quant_block_size)
        # the model quantizes KV on write (cfg.kv_quant); the engine knob
        # only cross-checks it
        cfg_kv = self.cfg.kv_quant
        if kv_quant is not None:
            if kv_quant not in ("nf4", "int8"):
                raise ValueError(f"unknown kv_quant format {kv_quant!r}")
            if cfg_kv is None:
                raise ValueError(
                    "kv_quant= requires the model cfg to set kv_quant "
                    "(the decode step quantizes KV on write)")
            if kv_quant != cfg_kv:
                raise ValueError(
                    f"engine kv_quant={kv_quant!r} conflicts with model "
                    f"cfg.kv_quant={cfg_kv!r}")
        self.kv_quant = cfg_kv
        self.params = params
        # bank mode: ``bank`` resolves tenant names, ``peft`` is what the
        # model reads (a pool's resident bank, swapped in place)
        self.bank = adapters
        self.pool = adapters if isinstance(adapters, AdapterPool) else None
        self.peft = (self.pool.device_bank() if self.pool is not None
                     else adapters if adapters is not None else peft)
        self.n_slots = n_slots
        self.max_len = max_len
        self.seq_bucket = seq_bucket
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.spec = model.cache_spec()
        self.pager = (PagedCacheView(model, n_slots, max_len, block_size,
                                     n_blocks, data_shards=self._dp)
                      if cache == "paged" else None)
        self._paged = self.pager is not None and self.pager.paged
        # spec of the serving cache: with quantized pools it has the
        # ``*_qscale`` leaves that every cache surgery must see
        self.serve_spec = self.pager.serve_spec if self._paged else self.spec
        if mesh is None:
            self.cache = (self.pager.init_cache() if self.pager is not None
                          else model.init_cache(n_slots, max_len))
        else:
            self._place(n_slots, max_len)
        self._lengths = np.zeros((n_slots,), np.int32)      # host-side
        self._last_token = np.zeros((n_slots,), np.int32)
        # per-slot global tenant ids (0 = base model), bank mode only
        self._adapter_ids = np.zeros((n_slots,), np.int32)
        # True where admission wrote ``_last_token`` after the last decode
        # dispatch: a chained dispatch takes those slots' tokens from the
        # host, the others from the device.  The closed loop never reads it.
        self._fresh = np.zeros((n_slots,), bool)
        # the clock of arrival stamps, TTFT and tick latency (a front end
        # or a test may swap in a virtual clock)
        self.clock: Callable[[], float] = time.monotonic
        # front-end hooks: where a preempted request requeues (default: the
        # engine's own queue front) and which slot a dry pool preempts
        # (default: the highest active slot)
        self.requeue_hook: Optional[Callable[[Request], None]] = None
        self.victim_hook: Optional[
            Callable[[List[int], List[Optional[Request]]], int]] = None
        self.tick_hist = LatencyHistogram()
        self.ttft_hists: Dict[str, LatencyHistogram] = {}
        # adapter bytes: resident (what the ticks read: one set, a static
        # bank or the pool's rows) and registry (a pool's tenants)
        if self.pool is not None:
            resident_b = self.pool.resident_nbytes()
            registry_b = self.pool.store.nbytes
        else:
            resident_b = (self.bank.nbytes if self.bank is not None
                          else tree_nbytes(getattr(peft, "tree", peft)
                                            or {}))
            registry_b = 0
        self.stats: Dict[str, Any] = {
            "prefill_calls": 0, "decode_calls": 0, "chunk_calls": 0,
            "tokens": 0, "preemptions": 0,
            "adapter_bytes": resident_b,
            "adapter_bytes_resident": resident_b,
            "adapter_bytes_registry": registry_b,
            "adapter_tenants": (self.bank.num_tenants
                                if self.bank is not None else 0),
            "param_bytes": tree_nbytes(self.params),
            "model_shards": self._tp.size,
            "base_quant": base_quant or "none",
            "kv_quant": self.kv_quant or "none",
        }

        # a frontend model is served text only, by replay, as in the JAX
        # engine: its prefill takes the frontend's embeddings, which no
        # request carries
        can_prefill = (hasattr(model, "prefill")
                       and self.cfg.frontend is None)
        if admission == "auto":
            admission = "prefill" if can_prefill else "replay"
        if admission not in ("prefill", "replay"):
            raise ValueError(f"unknown admission mode {admission!r}")
        if admission == "prefill" and not can_prefill:
            raise ValueError(
                f"model {self.cfg.name!r} cannot use prefill admission")
        if admission == "replay" and self._paged:
            raise ValueError(
                "replay admission writes through dense slot stripes; "
                "use admission='prefill' with the paged cache")
        self.admission = admission
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be positive")
        self.prefill_chunk = prefill_chunk
        # only a model with a chunk step chunks (Griffin has none and is
        # admitted by waves, as in the JAX engine)
        self._can_chunk = (prefill_chunk is not None and admission == "prefill"
                           and hasattr(model, "prefill_chunk"))
        # the one chunked admission in flight: req, slot, tokens, staging
        # cache, pos, tenant id
        self._chunking: Optional[Dict[str, Any]] = None

        # the decode tick's static buffers (this rank's slots), and its
        # graph
        dev = self.device
        rows = self._hi - self._lo
        self._io: Dict[str, torch.Tensor] = {
            "tokens": torch.zeros((rows, 1), dtype=torch.long, device=dev),
            "fresh": torch.ones((rows,), dtype=torch.bool, device=dev),
            "active": torch.zeros((rows,), dtype=torch.bool, device=dev),
            "sampled": torch.zeros((rows, 1), dtype=torch.long, device=dev),
        }
        if self._world > 1:
            # every slot's token, gathered over the data axes
            self._io["gathered"] = torch.zeros((n_slots, 1),
                                               dtype=torch.long, device=dev)
        # the slot-state leaves a tick overwrites for every slot in place
        # (``len``, and a recurrent model's O(1) states): their values
        # before the tick, put back where a slot is inactive.  Token-axis
        # leaves are not among them: a tick writes them past each slot's
        # length (or into the null block), where no reader looks.
        self._state_keys = [k for k, ls in self.serve_spec.items()
                            if not isinstance(ls, PagedCacheLeafSpec)]
        for k in self._state_keys:
            self._io[f"before.{k}"] = torch.empty_like(self.cache[k])
        if self.bank is not None:
            self._io["ids"] = torch.zeros((rows,), dtype=torch.int32,
                                          device=dev)
        self._all_fresh = np.ones((n_slots,), bool)
        self._decode = _DecodeGraph(self._tick_body, self._tick_buffers, dev)
        # more than one rank: the tick's token gather is a collective, and
        # the tick runs eagerly
        self._decode.eager = self._world > 1
        self._landing: Optional[_Landing] = None
        self.compile_guard = sanitize.CompileGuard("ServingEngine")
        if dev.type == "cuda":
            self.compile_guard.register("decode", self._decode,
                                        self.compilation_bounds()["decode"])
        self._update_gauges()

    # ------------------------------------------------------------------ mesh
    def _mesh_layout(self, mesh, n_slots: int, model) -> None:
        """This rank's share of the slots under ``mesh``: data shard
        ``_shard`` of ``_dp`` owns slots ``[_lo, _hi)``; ``_lead`` ranks
        (coordinate 0 off the data axes) share their shard's tokens;
        ``_tp`` is the rank's `model` group for the dense family (a group
        of one otherwise), and ``_model_kw`` what the model calls take for
        it."""
        self.mesh = mesh
        self._dp, self._shard, self._world, self._lead = 1, 0, 1, True
        self._lo, self._hi = 0, n_slots
        self._tp, self._model_kw = ONE, {}
        if mesh is None:
            return
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.launch.mesh import (
            dp_axes, dp_index, dp_size, mesh_coordinate,
        )

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f"mesh= takes a torch DeviceMesh (launch.mesh."
                f"make_host_mesh), got {type(mesh).__name__}")
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot serve an "
                             f"engine on {self.device}")
        self._world = dist.get_world_size()
        if mesh.size() != self._world:
            raise ValueError(f"the mesh has {mesh.size()} ranks, the process "
                             f"group {self._world}: serve over all of it")
        dp = dp_size(mesh)
        if dp > 1 and n_slots % dp:
            # the slot axis shards over the data axes: an uneven split
            # would mis-shard the cache
            raise ValueError(
                f"n_slots={n_slots} must be a multiple of the mesh "
                f"data-parallel size {dp}: the slot axis shards over the "
                "data axes")
        self._dp, self._shard = dp, dp_index(mesh)
        rows = n_slots // dp
        self._lo, self._hi = self._shard * rows, (self._shard + 1) * rows
        data = dp_axes(mesh)
        self._lead = all(v == 0 for a, v in mesh_coordinate(mesh).items()
                         if a not in data)
        if isinstance(model, Transformer) and not model.cfg.is_moe:
            self._tp = model_group(mesh)
            if self._tp.size > 1:
                self._model_kw = {"tp": self._tp}

    def _check_tp(self, adapters) -> None:
        """What a `model` split of the dense family refuses: a head count,
        ``d_ff`` or ``d_model`` that ``m`` does not divide, and adapters
        other than LoRA and QuanTA."""
        cfg, m = self.cfg, self._tp.size
        for n, what in ((cfg.n_heads, "n_heads"),
                        (cfg.n_kv_heads, "n_kv_heads")):
            if n % m:
                raise ValueError(
                    f"model={m} does not divide {what}={n}: the port's "
                    "attention kernels take whole local heads, and the "
                    "JAX package's head_dim split is a ROADMAP item")
        for n, what in ((cfg.d_ff, "d_ff"), (cfg.d_model, "d_model")):
            if n % m:
                raise ValueError(f"model={m} does not divide {what}={n}")
        tree = getattr(adapters, "tree", adapters) or {}
        for leaf in flatten_paths(tree).values():
            for a in getattr(leaf, "groups", (leaf,)):
                if not a.shardable:
                    raise ValueError(unsharded_method(a))

    def _place(self, n_slots: int, max_len: int) -> None:
        """Place adapters and the cache under ``self.mesh`` (the cache
        over the data axes only; see the module docstring)."""
        from repro_torch.launch.mesh import dp_axes
        from repro_torch.launch.shardings import (
            P, cache_shardings, peft_shardings, placed_zeros,
        )

        mesh = self.mesh
        if self.pool is not None:
            self.peft_specs = self.pool.place(mesh)
            self.peft = self.pool.device_bank()
        else:
            self.peft_specs = peft_shardings(mesh, self.peft)
        if self.pager is not None:
            struct = self.pager.meta_struct()
        else:
            struct = self.model.init_cache(n_slots, max_len, device="meta")
        data = set(dp_axes(mesh))

        def data_only(spec):
            return P(*(e if e is not None and set(
                (e,) if isinstance(e, str) else e) <= data else None
                for e in spec))

        def kv_heads(key, spec):
            # the KV-head axis (..., KV, hd) of a KV leaf over `model`
            if self._tp.size == 1 or not isinstance(self.serve_spec[key],
                                                    PagedCacheLeafSpec):
                return spec
            return P(*spec[:-2], "model", spec[-1])

        specs = cache_shardings(
            self.cfg, mesh, struct, spec=self.serve_spec, paged=self._paged,
            pool_data_shards=self.pager.data_shards if self._paged else None)
        self.cache_specs = {k: kv_heads(k, data_only(v))
                            for k, v in specs.items()}
        placed = (self.pager.init_cache(mesh, self.cache_specs)
                  if self.pager is not None
                  else placed_zeros(struct, mesh, self.cache_specs,
                                    self.device))
        self.placed_cache = placed
        self.cache = {k: v.to_local() for k, v in placed.items()}

    def _share_tokens(self, toks: Optional[torch.Tensor], mine,
                      n: int) -> torch.Tensor:
        """The ``n`` device tokens of which this rank computed ``toks``,
        entries ``mine`` (None where it computed none), on every rank:
        one ``all_reduce`` to which the lead rank of each data shard
        contributes.  A world of one computed all of them."""
        if self._world == 1:
            return toks
        import torch.distributed as dist

        out = torch.zeros((n,), dtype=torch.long, device=self.device)
        if self._lead and len(mine):
            out[torch.as_tensor(mine, device=self.device)] = toks
        dist.all_reduce(out)
        return out

    def _local_slots(self, slot_ids):
        """``(positions, local slot indices)`` of the slots in
        ``slot_ids`` this rank holds."""
        pos = [i for i, s in enumerate(slot_ids)
               if self._lo <= int(s) < self._hi]
        return pos, np.asarray([int(slot_ids[i]) - self._lo for i in pos],
                               np.int64)

    # ------------------------------------------------------ capture bounds
    def compilation_bounds(self) -> Dict[str, int]:
        """Documented capture bound per captured entry point.

        * ``decode`` -- 1: every tick decodes the whole fixed-shape slot
          batch over the same static buffers (tokens, masks, tenant ids,
          block tables), so one graph is captured per engine, at the first
          tick, and replayed ever after.

        Prefill waves, chunk steps and the insert scatter run eagerly
        (their shapes vary with the wave and the prompt, and they are
        bound by the device), so they have no graph and no bound; the
        greedy sample and the token merge are part of the decode graph.
        ``compile_guard`` asserts these every tick under
        ``REPRO_SANITIZE=1`` (``repro_torch.analysis.sanitize``).
        """
        return {"decode": 1}

    # ------------------------------------------------------------- frontend
    def submit(self, req: Request, adapter: Optional[str] = None) -> None:
        """Queue a request; ``adapter`` (or ``req.adapter``) names its bank
        tenant, ``None`` the base model."""
        self.validate(req, adapter)
        self.queue.append(req)

    def validate(self, req: Request, adapter: Optional[str] = None) -> None:
        """Check ``req`` against this engine and stamp it (its tenant, and
        ``arrival_time`` when unset), without queueing it; an unknown
        tenant fails here."""
        name = adapter if adapter is not None else req.adapter
        if name is not None and self.bank is None:
            raise ValueError(
                f"request {req.uid} names adapter {name!r} but the engine "
                "has no AdapterBank (pass adapters= at construction)")
        if self.bank is not None:
            self.bank.id_of(name)
        if not req.prompt:
            raise ValueError("empty prompt")
        if len(req.prompt) >= self.max_len:
            raise ValueError("prompt longer than engine max_len")
        if self._paged:
            # a request that could never fit alone would livelock
            # admission and preemption
            worst = min(len(req.prompt) + req.max_new_tokens, self.max_len)
            need = self.pager.blocks_for(worst)
            usable = self.pager.max_request_blocks
            if need > usable:
                raise ValueError(
                    f"request needs up to {need} blocks but the pool only "
                    f"has {usable}; it could never be admitted")
        if adapter is not None:
            req.adapter = adapter        # stamped once fully validated
        if req.arrival_time is None:
            req.arrival_time = self.clock()

    def _req_adapter_id(self, req: Request) -> int:
        return self.bank.id_of(req.adapter) if self.bank is not None else 0

    def _device_ids(self, ids: np.ndarray) -> Optional[torch.Tensor]:
        """The per-row tenant ids of one eager model call, on the device
        (bank mode), else None."""
        if self.bank is None:
            return None
        return torch.from_numpy(ids).to(self.device)

    def _acquire_adapter(self, req: Request) -> bool:
        """Pool mode: pin the request's tenant, loading it if needed;
        False defers the request.  Static banks are always ready."""
        return self.pool is None or self.pool.acquire(req.adapter)

    def _release_adapter(self, req: Request) -> None:
        """Pool mode: unpin when the request leaves its slot."""
        if self.pool is not None:
            self.pool.release(req.adapter)

    @staticmethod
    def _tokens(req: Request) -> List[int]:
        """Admission tokens: a preempted request re-admits with what it
        generated as part of its prompt (recompute preemption)."""
        return req.prompt + req.output if req.output else req.prompt

    def _free_slots(self) -> List[int]:
        reserved = (self._chunking["slot"] if self._chunking is not None
                    else None)
        return [i for i, r in enumerate(self.slots)
                if r is None and i != reserved]

    def _bucket(self, n: int) -> int:
        return min(-(-n // self.seq_bucket) * self.seq_bucket, self.max_len)

    def _note_first_token(self, req: Request) -> None:
        """Stamp a request's time to first token at its first token ever
        (a preempted request keeps its stamp) and record it in its class's
        TTFT histogram."""
        if req.first_token_time is not None:
            return
        now = self.clock()
        req.first_token_time = now
        if req.arrival_time is not None:
            hist = self.ttft_hists.get(req.latency_class)
            if hist is None:
                hist = self.ttft_hists[req.latency_class] = LatencyHistogram()
            hist.record(max(now - req.arrival_time, 0.0))

    def ttft_all(self) -> LatencyHistogram:
        """TTFT across every latency class (merged counts)."""
        merged = LatencyHistogram()
        for hist in self.ttft_hists.values():
            merged.merge(hist)
        return merged

    def queue_depths(self) -> Dict[str, int]:
        """Queued requests per latency class, of the engine's own queue
        (the SLA front end overwrites the gauge from its class queues)."""
        depths: Dict[str, int] = {}
        for req in self.queue:
            depths[req.latency_class] = depths.get(req.latency_class, 0) + 1
        return depths

    def _update_gauges(self) -> None:
        ttft = self.ttft_all()
        self.stats.update(
            ttft_p50=ttft.percentile(50), ttft_p99=ttft.percentile(99),
            tick_p50=self.tick_hist.percentile(50),
            tick_p99=self.tick_hist.percentile(99),
            queue_depth=self.queue_depths(),
        )
        if self.pool is not None:
            self.stats.update(self.pool.stats())
            self.stats["adapter_bytes"] = self.stats["adapter_bytes_resident"]
        if self.pager is not None:
            self.stats.update(self.pager.stats())
            self.stats["kv_quant"] = self.stats.get("kv_quant") or "none"
        elif "cache_bytes_allocated" not in self.stats:
            self.stats.update(
                blocks_in_use=0, blocks_total=0, peak_blocks_in_use=0,
                cache_bytes_allocated=tree_nbytes(self.cache),
                peak_block_utilization=0.0)

    # ------------------------------------------------------------ admission
    def _admit(self, queue=None, chunk: bool = True) -> None:
        """One admission pass.  ``queue`` stands in for the engine's queue
        (anything with truthiness, ``[0]`` and ``popleft``: the SLA front
        end passes its ready view); ``chunk=False`` skips the one chunk a
        tick of an in-flight chunked admission, whose cadence the front
        end's interleave policy then drives."""
        if chunk:
            self._step_chunked()
        q = self.queue if queue is None else queue
        free = self._free_slots()
        if not free or not q:
            return
        wave: List[Request] = []
        while q and len(wave) < len(free):
            nxt = q[0]
            n_tok = len(self._tokens(nxt))
            if self._paged:
                # a remaining free slot whose arena holds the request: a
                # full arena must not hold up admission into another
                # shard's free slots
                cand = next((j for j in range(len(wave), len(free))
                             if self.pager.can_admit(n_tok, free[j])), None)
                if cand is None:
                    break             # no arena has room: wait for frees
                free[len(wave)], free[cand] = free[cand], free[len(wave)]
            if self._can_chunk and n_tok > self.prefill_chunk:
                # a long prompt goes through the chunked pipeline (one at
                # a time); shorter ones behind it may still join the wave
                if self._chunking is not None:
                    break
                if not self._acquire_adapter(nxt):
                    break             # tenant cannot be loaded: defer
                self._start_chunked(q.popleft(), free[len(wave)])
                free = [s for s in free if s != self._chunking["slot"]]
                continue
            if not self._acquire_adapter(nxt):
                break                 # tenant cannot be loaded: defer
            if self._paged:
                # reserve now, so later wave members and alloc-on-append
                # see the smaller pool
                self.pager.ensure(free[len(wave)], n_tok)
            wave.append(q.popleft())
        if not wave:
            if self.pool is not None:
                self._update_gauges()  # a deferral moves the pool's gauges
            return
        if self.admission == "prefill":
            self._admit_prefill(free, wave)
        else:
            self._admit_replay(free, wave)

    def _admit_prefill(self, free: Sequence[int], wave: List[Request]) -> None:
        """One prefill over the right-padded wave, then scatter its cache
        stripes into the free slots.  Under a mesh a data rank prefills the
        rows of its own slots (padded to its ``n_slots / dp`` rows)."""
        streams = [self._tokens(r) for r in wave]
        lengths = np.array([len(p) for p in streams], np.int32)
        aids = np.array([self._req_adapter_id(r) for r in wave], np.int32)
        slot_ids = np.asarray(free[: len(wave)], np.int64)
        mine, _ = self._local_slots(slot_ids)
        s = self._bucket(int(lengths.max()))
        rows = self._hi - self._lo
        toks = np.zeros((rows, s), np.int64)
        lens = np.ones((rows,), np.int32)     # dummy rows: length 1
        wave_ids = np.zeros((rows,), np.int32)  # dummy rows: base
        for row, i in enumerate(mine):
            toks[row, : lengths[i]] = streams[i]
            lens[row] = lengths[i]
            wave_ids[row] = aids[i]
        first, wave_cache = None, None
        if mine:
            logits, wave_cache = self.model.prefill(
                self.params, self.peft,
                {"tokens": torch.from_numpy(toks).to(self.device)},
                lengths=torch.from_numpy(lens).to(self.device),
                adapter_ids=self._device_ids(wave_ids), **self._model_kw,
            )
            first = self._sample(logits)[: len(mine), 0]
        self.stats["prefill_calls"] += 1
        self._insert_wave(slot_ids, wave_cache, lengths)
        first = self._share_tokens(first, mine, len(wave)).cpu().numpy()  # repro: allow(host-sync) the wave's first tokens land once per admission, not per tick
        for row, (slot, req) in enumerate(zip(free, wave)):
            self._land_admitted(slot, req, int(lengths[row]),
                                int(aids[row]), int(first[row]))
        self._update_gauges()

    def _land_admitted(self, slot: int, req: Request, length: int, aid: int,
                       tok: int) -> None:
        """A request admitted into ``slot`` with its first token."""
        self.slots[slot] = req
        self._lengths[slot] = length
        self._adapter_ids[slot] = aid
        self._last_token[slot] = tok
        self._fresh[slot] = True
        req.output.append(tok)
        self.stats["tokens"] += 1
        self._note_first_token(req)

    def _insert_wave(self, slot_ids, wave_cache, lengths) -> None:
        """Land a prefill wave (or a finished staging cache) in the serving
        cache: by slot, or through the block tables after allocating each
        row's blocks.  ``wave_cache`` holds, in order, the rows of the
        slots of ``slot_ids`` this rank holds (every slot without a mesh;
        None where it holds none).  Every rank allocates every row's
        blocks (the tables are shared) and lands its own rows, in its own
        arena."""
        if self._paged:
            for slot, n in zip(slot_ids, lengths):
                self.pager.ensure(int(slot), int(n))
        mine, local = self._local_slots(slot_ids)
        if not mine:
            return
        lengths = np.asarray(lengths)[mine]
        if not self._paged:
            self.model.insert_cache(self.cache, local, wave_cache, lengths)
            return
        nb = -(-self.pager.wave_page_extent(wave_cache)
               // self.pager.block_size)
        # global pool rows to this rank's arena rows
        tables = (self.pager.wave_tables(np.asarray(slot_ids)[mine], nb)
                  - self._arena_base())
        insert_cache_slots(self.serve_spec, self.cache, local, wave_cache,
                           lengths, block_tables=tables)

    def _arena_base(self) -> int:
        """The first global pool row of the arena this rank holds (0
        when it holds the whole pool)."""
        if not self._paged or self.pager.data_shards == 1:
            return 0
        return self.pager.null_of(self._shard)

    # --------------------------------------------------- chunked admission
    def _start_chunked(self, req: Request, slot: int) -> None:
        # The staging cache must be chunk-aligned, not just bucketed: every
        # chunk writes a full (1, C) K/V slab at pos, and a shorter buffer
        # would clamp the last slab's start over earlier rows.  It may
        # exceed max_len by < C + seq_bucket; the insert scatter slices
        # oversized staging axes back to the cache extent.
        c = self.prefill_chunk
        tokens = self._tokens(req)
        need = -(-len(tokens) // c) * c
        s_stage = -(-need // self.seq_bucket) * self.seq_bucket
        if self._paged:
            # reserve the whole prompt's blocks now (the admission loop
            # checked can_admit), so a concurrent wave or append cannot
            # take them before the staging cache lands
            self.pager.ensure(slot, len(tokens))
        # under a mesh only the slot's data shard stages and runs chunks
        own = self._lo <= slot < self._hi
        self._chunking = {
            "req": req,
            "slot": slot,
            "tokens": tokens,
            "staged": (self.model.init_cache(1, s_stage, **self._model_kw)
                       if own else None),
            "pos": 0,
            "aid": self._req_adapter_id(req),
        }

    def _step_chunked(self) -> None:
        """Advance the in-flight chunked admission by one chunk (the
        closed loop calls it once a tick, so decode ticks interleave)."""
        if self._chunking is None:
            return
        st = self._chunking
        req, c = st["req"], self.prefill_chunk
        tokens, pos = st["tokens"], st["pos"]
        n_valid = min(c, len(tokens) - pos)
        toks = np.zeros((1, c), np.int64)
        toks[0, :n_valid] = tokens[pos: pos + n_valid]
        own = st["staged"] is not None
        if own:
            logits, st["staged"] = self.model.prefill_chunk(
                self.params, self.peft,
                {"tokens": torch.from_numpy(toks).to(self.device)},
                st["staged"], pos, n_valid,
                adapter_ids=self._device_ids(np.asarray([st["aid"]],
                                                        np.int32)),
                **self._model_kw,
            )
        self.stats["chunk_calls"] += 1
        st["pos"] = pos + n_valid
        if st["pos"] < len(tokens):
            return
        # the last chunk: its first token, and the same insert scatter as
        # a wave
        slot = st["slot"]
        self._insert_wave(np.asarray([slot], np.int64), st["staged"],
                          np.asarray([len(tokens)], np.int32))
        tok = self._sample(logits)[0] if own else None
        tok = int(self._share_tokens(tok, [0] if own else [], 1).cpu()[0])  # repro: allow(host-sync) the first token lands once, after a request's last chunk
        self._chunking = None
        self._land_admitted(slot, req, len(tokens), st["aid"], tok)
        self._update_gauges()

    # ---------------------------------------------------- replay admission
    def _admit_replay(self, free: Sequence[int], wave: List[Request]) -> None:
        """Prompts step token by token through the decode tick into their
        slots' stripes, the whole wave together, each step with the wave's
        own active mask (on the card: the captured graph)."""
        streams = [self._tokens(r) for r in wave]
        max_p = max(len(p) for p in streams)
        _, local = self._local_slots(free[: len(wave)])
        reset_cache_slots(self.spec, self.cache, local)
        for slot, req in zip(free, wave):
            self._adapter_ids[slot] = self._req_adapter_id(req)
        for t in range(max_p):
            toks = np.zeros((self.n_slots, 1), np.int64)
            active = np.zeros((self.n_slots,), bool)
            for slot, p in zip(free, streams):
                if t < len(p):
                    toks[slot, 0] = p[t]
                    active[slot] = True
            self.dispatch_decode(toks, active)
            ends = [(slot, req, p) for slot, req, p in zip(free, wave, streams)
                    if t == len(p) - 1]
            if ends:
                nxt = self._landing.tokens()
                for slot, req, p in ends:
                    self._land_admitted(slot, req, len(p),
                                        int(self._adapter_ids[slot]),
                                        int(nxt[slot]))
        self._update_gauges()

    # ----------------------------------------------------------- preemption
    def _preempt(self, slot: int) -> None:
        """Recompute preemption: free the slot's blocks and requeue its
        request (``requeue_hook``, else the queue front); it re-admits with
        ``prompt + output`` as its prefix, which continues its greedy
        stream.  The same ``Request`` object is requeued, so its arrival,
        class and output survive."""
        req = self.slots[slot]
        self.slots[slot] = None
        self._adapter_ids[slot] = 0
        self.pager.release(slot)
        # unpin: the tenant may be evicted while the request waits, and
        # re-admission acquires it again (the request keeps its tenant)
        self._release_adapter(req)
        (self.requeue_hook or self.queue.appendleft)(req)
        self.stats["preemptions"] += 1

    def _ensure_growth(self, active: np.ndarray) -> None:
        """Alloc on append: every active slot must hold one more token
        before the decode tick.  When the pool is dry, preempt a victim
        among the active slots (``victim_hook``, else the highest; it
        frees at least one block, so the retry cannot fail) and let the
        others decode; ``active`` is updated in place."""
        for i in range(self.n_slots):
            if not active[i]:
                continue
            try:
                self.pager.ensure(i, int(self._lengths[i]) + 1)
            except MemoryError:
                # the victim shares slot i's arena (a victim elsewhere
                # frees nothing slot i can use)
                shard = self.pager.shard_of(i)
                cands = [j for j in range(self.n_slots)
                         if active[j] and self.pager.shard_of(j) == shard]
                victim = (self.victim_hook(cands, self.slots)
                          if self.victim_hook is not None else max(cands))
                self._preempt(victim)
                active[victim] = False
                if active[i]:
                    self.pager.ensure(i, int(self._lengths[i]) + 1)

    # ----------------------------------------------------------------- tick
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy tokens ``(B, 1)`` from ``(B, 1, V)`` logits, on the
        device."""
        return torch.argmax(logits[:, :, : self.cfg.vocab_size], dim=-1)

    def _tick_buffers(self) -> Dict[str, torch.Tensor]:
        """Every tensor the decode graph reads or writes by address."""
        out = {f"cache.{k}": v for k, v in self.cache.items()}
        out.update((f"io.{k}", v) for k, v in self._io.items())
        if self._paged:
            out["tables"] = self.pager.device_tables()
        return out

    def _tick_tables(self) -> Optional[torch.Tensor]:
        """This rank's slots' rows of the device block tables (global pool
        rows), or None for a dense cache."""
        if not self._paged:
            return None
        return self.pager.device_tables()[self._lo:self._hi]

    def _tick_body(self):
        """One decode tick over the static buffers: the token merge, the
        decode step (the cache updated in place), the active-slot merge
        of the slot-state leaves (``len``, recurrent states), the greedy
        sample into ``io["sampled"]``.  Returns the ``(B, 1, V)`` logits
        and the sampled tokens."""
        io = self._io
        toks = torch.where(io["fresh"][:, None], io["tokens"], io["sampled"])
        cache = self.cache
        before = {k: io[f"before.{k}"] for k in self._state_keys}
        for k, t in before.items():
            t.copy_(cache[k])
        # the mesh reaches attention only when the pool has an arena a
        # data shard
        kw = dict(self._model_kw)
        if self._paged and self.pager.data_shards > 1:
            kw["mesh"] = self.mesh
        logits, new_cache = self.model.decode_step(
            self.params, self.peft, cache, {"tokens": toks},
            block_tables=self._tick_tables(), adapter_ids=io.get("ids"), **kw)
        merge_cache_slots(self.serve_spec, new_cache,
                          dict(new_cache, **before), io["active"],
                          skip_paged=self._paged)
        io["sampled"].copy_(self._sample(logits))
        if self._world == 1:
            return logits, io["sampled"]
        import torch.distributed as dist

        out = io["gathered"]
        out.zero_()
        if self._lead:
            out[self._lo:self._hi] = io["sampled"]
        dist.all_reduce(out)
        return logits, out

    def _upload_tick(self, toks, active: np.ndarray,
                     fresh: Optional[np.ndarray]) -> None:
        """The tick's inputs into the static buffers.  ``toks``: ``(B, 1)``
        or ``(B,)`` host tokens, or a ``(B, 1)`` device tensor."""
        io = self._io
        lo, hi = self._lo, self._hi
        if isinstance(toks, torch.Tensor):
            io["tokens"].copy_(toks.reshape(self.n_slots, 1)[lo:hi])
        else:
            upload(io["tokens"],
                   np.asarray(toks, np.int64).reshape(-1, 1)[lo:hi])
        upload(io["active"], np.asarray(active, bool)[lo:hi])
        upload(io["fresh"], (self._all_fresh if fresh is None
                             else np.asarray(fresh, bool))[lo:hi])
        if "ids" in io:
            upload(io["ids"], self._adapter_ids[lo:hi])
        if self._paged:
            self.pager.device_tables()          # refreshed after edits

    def dispatch_decode(self, toks, active: np.ndarray,
                        fresh: Optional[np.ndarray] = None) -> torch.Tensor:
        """One fused decode tick for the whole slot batch; returns its
        ``(B, 1, V)`` logits (the graph's output buffer on the card: valid
        until the next tick; under a mesh, this rank's slots' rows).  Only
        ``active`` slots advance their length.
        ``fresh`` (default: every slot) marks the slots whose token comes
        from ``toks``; the others take the previous tick's sampled token
        on the device (a chained dispatch).  The tick's sampled tokens
        start their copy to the host at once (``_landing``)."""
        self._upload_tick(toks, active, fresh)
        logits, sampled = self._decode()
        self._landing = _Landing(sampled)
        self.stats["decode_calls"] += 1
        # what admission stamped before this dispatch is now on the device
        self._fresh[:] = False
        return logits

    def _postprocess(self, nxt: np.ndarray, active: np.ndarray) -> None:
        """Land one tick's sampled tokens: outputs, lengths, and slots
        freed on EOS, token budget or ``max_len``.  ``active`` is the
        tick's dispatch-time mask (a front end lands a tick one dispatch
        late, after newer admissions)."""
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            tok = int(nxt[i])
            req.output.append(tok)
            self.stats["tokens"] += 1
            self._last_token[i] = tok
            self._lengths[i] += 1
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.output) >= req.max_new_tokens or \
                    self._lengths[i] >= self.max_len - 1:
                req.done = True
                self.slots[i] = None
                self._adapter_ids[i] = 0      # freed slots decode as base
                self._release_adapter(req)
                if self._paged:
                    self.pager.release(i)       # free on eviction
        if self._paged:
            self._update_gauges()

    def step(self) -> None:
        t0 = self.clock()
        self._admit()
        active = np.array([r is not None for r in self.slots])
        if not active.any():
            return
        if self._paged:
            self._ensure_growth(active)
            if not active.any():
                return
        self.dispatch_decode(self._last_token, active)
        self._postprocess(self._landing.tokens(), active)
        self.tick_hist.record(max(self.clock() - t0, 0.0))
        if sanitize.enabled():
            self.compile_guard.assert_ok()

    def run(self, max_ticks: int = 10_000) -> None:
        ticks = 0
        while (self.queue or any(self.slots)
               or self._chunking is not None) and ticks < max_ticks:
            self.step()
            ticks += 1
