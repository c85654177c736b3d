"""QuanTA: quantum-informed tensor adaptation (port of
``repro/core/quanta.py``).

A hidden vector is viewed as an N-axis register and a chain of two-axis
tensors is applied to it in schedule order (paper Eq. 4-5).  Conventions
are the JAX package's: ``y = x @ W`` with ``W (d_in, d_out)``; each tensor
is ``(out_m, out_n, in_m, in_n)`` for its axis pair ``(m, n)``; the list
order is the application order; only axis 0 may be rectangular (App. B).

Zero initialization (Eq. 8/9), in one of two forms:

* folded (the paper's deployment form): the frozen copy S is subtracted
  from the base weight at attach time (``fold_frozen_copy``: ``W0' = W0 -
  S``), and the adapted layer is ``x @ W0' + T x``;
* fold-free (``PeftConfig(fold=False)``): the base stays untouched and the
  adapter carries S as factor tensors (:attr:`QuantaAdapter.frozen`), so
  the layer is ``x @ W0 + (T x - S x)`` with S detached: the chain is
  linear in x, so gradients still reach x through S's chain.
"""

from __future__ import annotations

import dataclasses
import math
import string
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.adapters import Adapter, base_matmul, tree_map
from repro_torch.core.factorize import factorize, pair_schedule, param_count
from repro_torch.core.quantize import QuantizedLinear

__all__ = [
    "QuantaAdapter",
    "get_symbol",
    "apply_einsum_expr",
    "tensor_shapes",
    "init_tensors",
    "apply_sequential",
    "apply_einsum",
    "materialize",
    "fold_frozen_copy",
    "merge",
]

_SYMBOLS = string.ascii_lowercase + string.ascii_uppercase


def get_symbol(i: int) -> str:
    """Einsum subscript symbol #i."""
    if i >= len(_SYMBOLS):
        raise ValueError(f"einsum expression needs too many symbols ({i})")
    return _SYMBOLS[i]


def tensor_shapes(
    dims_in: Sequence[int],
    pairs: Sequence[Tuple[int, int]],
    dims_out: Sequence[int] | None = None,
) -> Tuple[Tuple[int, int, int, int], ...]:
    """Shape ``(out_m, out_n, in_m, in_n)`` of every tensor of the
    schedule; the first tensor touching axis 0 maps ``dims_in[0] ->
    dims_out[0]``."""
    dims_out = tuple(dims_out) if dims_out is not None else tuple(dims_in)
    if len(dims_out) != len(dims_in):
        raise ValueError("dims_in and dims_out must have equal length")
    for ax, (di, do) in enumerate(zip(dims_in, dims_out)):
        if ax != 0 and di != do:
            raise ValueError(
                "rectangular QuanTA may only change axis 0 "
                f"(axis {ax}: {di} -> {do})"
            )
    cur = list(dims_in)
    shapes = []
    for (m, n) in pairs:
        if not (0 <= m < n < len(cur)):
            raise ValueError(f"bad axis pair {(m, n)} for N={len(cur)}")
        om = dims_out[m] if m == 0 else cur[m]
        on = dims_out[n] if n == 0 else cur[n]
        shapes.append((om, on, cur[m], cur[n]))
        cur[m], cur[n] = om, on
    if tuple(cur) != dims_out:
        raise ValueError(
            f"schedule {tuple(pairs)} never maps dims_in[0] {dims_in[0]} to "
            f"dims_out[0] {dims_out[0]} (no tensor touches axis 0)"
        )
    return tuple(shapes)


def apply_einsum_expr(
    n_axes: int, pairs: Sequence[Tuple[int, int]] | None = None
) -> str:
    """Einsum expression applying the full chain to ``x`` (App. G): the
    symbol of a re-indexed axis is its old one plus ``n_axes``.

    >>> apply_einsum_expr(3)
    '...abc,efbc,diaf,ghde->...ghi'
    """
    pairs = tuple(pairs) if pairs is not None else pair_schedule(n_axes)
    cur = list(range(n_axes))
    expr = "..." + "".join(get_symbol(i) for i in cur)
    for (m, n) in pairs:
        sm, sn = cur[m], cur[n]
        om, on = sm + n_axes, sn + n_axes
        expr += ("," + get_symbol(om) + get_symbol(on) + get_symbol(sm)
                 + get_symbol(sn))
        cur[m], cur[n] = om, on
    return expr + "->..." + "".join(get_symbol(i) for i in cur)


def _identity_like(om, on, im, in_, dtype, device) -> torch.Tensor:
    """(Truncated/padded) identity for a tensor of shape (om,on,im,in)."""
    eye = torch.zeros((om * on, im * in_), dtype=dtype, device=device)
    k = min(om * on, im * in_)
    idx = torch.arange(k, device=device)
    eye[idx, idx] = 1.0
    return eye.reshape(om, on, im, in_)


def init_tensors(
    generator: torch.Generator,
    dims_in: Sequence[int],
    dims_out: Sequence[int] | None = None,
    pairs: Sequence[Tuple[int, int]] | None = None,
    *,
    init: str = "identity_noise",
    noise_scale: float = 0.02,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, ...]:
    """Initialize the tensor chain: (truncated) identity plus Gaussian
    noise (``identity_noise``), or i.i.d. Gaussian with 1/sqrt(fan_in)
    scaling (``normal``).  Draws come from ``generator`` (on ``device``)."""
    pairs = tuple(pairs) if pairs is not None else pair_schedule(len(dims_in))
    device = torch.device(device) if device is not None else generator.device
    tensors = []
    for (om, on, im, in_) in tensor_shapes(dims_in, pairs, dims_out):
        if device.type == "meta":           # shapes alone: nothing to draw
            tensors.append(torch.empty((om, on, im, in_), dtype=dtype,
                                       device=device))
            continue
        noise = torch.randn((om, on, im, in_), generator=generator,
                            dtype=dtype, device=device)
        if init == "identity_noise":
            t = _identity_like(om, on, im, in_, dtype, device) \
                + noise_scale * noise
        elif init == "normal":
            t = noise / math.sqrt(im * in_)
        else:
            raise ValueError(f"unknown init {init!r}")
        tensors.append(t)
    return tuple(tensors)


def _stage_product(h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``h (M, K) @ t (O, K)^T`` in fp32 (or wider), rounded to h's dtype.

    For 16-bit operands each product of two elements is exact in fp32, so
    adding them into an fp32 sum over k ascending from 0, one rounded add
    a term, gives the fp32 FMA chain the chain kernel runs, to the bit and
    whatever the device: a library product may split K where the problem
    is small (cuBLAS does at yi-6b's 16-16-16 decode stage, K = 256 over
    M = 128 rows), which moves a bf16 rounding now and then.  Wider
    operands take the library product."""
    acc = torch.promote_types(h.dtype, torch.float32)
    if max(h.element_size(), t.element_size()) > 2:
        return (h.to(acc) @ t.to(acc).T).to(h.dtype)
    hf, tf = h.to(acc), t.to(acc).T
    out = torch.zeros((h.shape[0], t.shape[0]), dtype=acc, device=h.device)
    for k in range(h.shape[1]):
        out.addcmul_(hf[:, k:k + 1], tf[k:k + 1])
    return out.to(h.dtype)


def apply_sequential(
    x: torch.Tensor,
    tensors: Sequence[torch.Tensor],
    dims_in: Sequence[int],
    pairs: Sequence[Tuple[int, int]],
    dims_out: Sequence[int] | None = None,
) -> torch.Tensor:
    """The chain as a sequence of batched matmuls: the pair axes move to
    the minor positions and contract with ``(om*on, im*in)``.  Each stage
    accumulates in fp32 (or wider) and is rounded to x's dtype before the
    next, as the chain kernel does (``_chain_block``); in a 16-bit dtype
    the sums run over k ascending as the kernel's do
    (:func:`_stage_product`).  This is the kernel's plain version."""
    dims_in = tuple(dims_in)
    batch_shape = x.shape[:-1]
    if x.shape[-1] != math.prod(dims_in):
        raise ValueError(f"x last dim {x.shape[-1]} != prod{dims_in}")
    nb = len(batch_shape)
    h = x.reshape(*batch_shape, *dims_in)
    for t, (m, n) in zip(tensors, pairs):
        om, on, im, in_ = t.shape
        h = torch.movedim(h, (nb + m, nb + n), (-2, -1))
        lead = h.shape[:-2]
        y2 = _stage_product(h.reshape(-1, im * in_),
                            t.reshape(om * on, im * in_))
        h = y2.reshape(*lead, om, on)
        h = torch.movedim(h, (-2, -1), (nb + m, nb + n))
    return h.reshape(*batch_shape, -1)


def apply_einsum(
    x: torch.Tensor,
    tensors: Sequence[torch.Tensor],
    dims_in: Sequence[int],
    pairs: Sequence[Tuple[int, int]],
    dims_out: Sequence[int] | None = None,
) -> torch.Tensor:
    """The chain as one joint einsum contraction (App. G)."""
    dims_in = tuple(dims_in)
    batch_shape = x.shape[:-1]
    h = x.reshape(*batch_shape, *dims_in)
    out = torch.einsum(apply_einsum_expr(len(dims_in), pairs), h, *tensors)
    return out.reshape(*batch_shape, -1)


def materialize(
    tensors: Sequence[torch.Tensor],
    dims_in: Sequence[int],
    pairs: Sequence[Tuple[int, int]],
    dims_out: Sequence[int] | None = None,
) -> torch.Tensor:
    """The full operator as a ``(d_in, d_out)`` matrix (the chain applied
    to the identity basis)."""
    d_in = math.prod(dims_in)
    eye = torch.eye(d_in, dtype=tensors[0].dtype, device=tensors[0].device)
    return apply_sequential(eye, tensors, dims_in, pairs, dims_out)


@dataclasses.dataclass(frozen=True)
class QuantaAdapter(Adapter):
    """QuanTA state of one linear layer (or of a stack of layers, when
    every tensor carries a leading layer axis; see ``layer``).

    Folded (``frozen is None``): ``y = x @ w0_folded + delta(x)`` (Eq. 9).
    Fold-free (``frozen`` holds S, the initialization copy of the chain):
    ``y = x @ w0 + (T x - S x)`` (Eq. 8), exactly the base model while T
    equals S.  S rides along with the trainable tensors but never gets a
    gradient (it is detached wherever it is applied) and is not counted by
    ``num_params``; train with ``weight_decay=0`` so that it stays put."""

    tensors: Tuple[torch.Tensor, ...]
    dims_in: Tuple[int, ...]
    dims_out: Tuple[int, ...]
    pairs: Tuple[Tuple[int, int], ...]
    frozen: Optional[Tuple[torch.Tensor, ...]] = None

    @staticmethod
    def create(
        generator: torch.Generator,
        d_in: int,
        d_out: int | None = None,
        *,
        n_axes: int = 4,
        dims_in: Sequence[int] | None = None,
        dims_out: Sequence[int] | None = None,
        pairs: Sequence[Tuple[int, int]] | None = None,
        init: str = "identity_noise",
        noise_scale: float = 0.02,
        dtype=torch.float32,
        device=None,
    ) -> "QuantaAdapter":
        d_out = d_out if d_out is not None else d_in
        if dims_in is None:
            dims_in = factorize(d_in, n_axes)
        dims_in = tuple(dims_in)
        if math.prod(dims_in) != d_in:
            raise ValueError(f"prod{dims_in} != d_in={d_in}")
        if dims_out is None:
            if d_out == d_in:
                dims_out = dims_in
            else:
                if d_out % (d_in // dims_in[0]) != 0:
                    raise ValueError(
                        f"d_out={d_out} not reachable from dims_in={dims_in} "
                        "by changing axis 0 only"
                    )
                dims_out = (d_out * dims_in[0] // d_in,) + dims_in[1:]
        dims_out = tuple(dims_out)
        if math.prod(dims_out) != d_out:
            raise ValueError(f"prod{dims_out} != d_out={d_out}")
        pairs = tuple(pairs) if pairs is not None else pair_schedule(len(dims_in))
        tensors = init_tensors(
            generator, dims_in, dims_out, pairs,
            init=init, noise_scale=noise_scale, dtype=dtype, device=device,
        )
        return QuantaAdapter(tensors, dims_in, dims_out, pairs)

    @property
    def d_in(self) -> int:
        return math.prod(self.dims_in)

    @property
    def d_out(self) -> int:
        return math.prod(self.dims_out)

    @property
    def num_params(self) -> int:
        """Trainable parameters: the chain T (S is not counted)."""
        per_layer = param_count(self.dims_in, self.pairs, self.dims_out)
        stacked = self.tensors[0].dim() == 5
        return per_layer * (self.tensors[0].shape[0] if stacked else 1)

    @property
    def fold_free(self) -> bool:
        """True when the adapter carries the frozen copy S (Eq. 8)."""
        return self.frozen is not None

    def frozen_detached(self) -> Tuple[torch.Tensor, ...]:
        """S, cut from autograd."""
        return tuple(s.detach() for s in self.frozen)

    def unfrozen(self, tensors: Optional[Tuple[torch.Tensor, ...]] = None
                 ) -> "QuantaAdapter":
        """A folded-form view over ``tensors`` (default: the chain T), to
        run each chain of the fold-free pair through the chain kernel."""
        t = self.tensors if tensors is None else tensors
        return QuantaAdapter(t, self.dims_in, self.dims_out, self.pairs)

    def delta(self, x: torch.Tensor) -> torch.Tensor:
        """``T x`` (folded) or ``T x - S x`` (fold-free) in the tensors'
        dtype, cast back to x's."""
        h = x.to(self.tensors[0].dtype)
        y = apply_sequential(h, self.tensors, self.dims_in, self.pairs,
                             self.dims_out)
        if self.frozen is not None:
            y = y - apply_sequential(h, self.frozen_detached(), self.dims_in,
                                     self.pairs, self.dims_out)
        return y.to(x.dtype)

    def matrix(self) -> torch.Tensor:
        """Full ``(d_in, d_out)`` update matrix (fold-free: minus S's)."""
        m = materialize(self.tensors, self.dims_in, self.pairs,
                        self.dims_out)
        if self.frozen is not None:
            m = m - materialize(self.frozen_detached(), self.dims_in,
                                self.pairs, self.dims_out)
        return m

    def apply(self, x: torch.Tensor, w: torch.Tensor,
              backend: str = "reference") -> torch.Tensor:
        """Adapted linear ``x @ w + delta(x)``.

        ``backend="pallas"`` (the name the configs carry: the hand-written
        kernels) goes through the two-phase ``quanta_linear`` kernel for a
        dense ``w``, which raises for a weight that is not 2-D; for a
        quantized ``w`` through the dequant-matmul kernel plus the chain
        kernel, cast to x's dtype.  A fold-free adapter takes the base
        product and two chain-kernel launches, one for T and one for S.
        ``"reference"`` is plain PyTorch.
        """
        return self.apply_cols(x, w, (0, self.d_out), backend)

    def _delta_on(self, x: torch.Tensor, backend: str) -> torch.Tensor:
        """``delta(x)``; under ``"pallas"`` through the chain kernel (T,
        and S for a fold-free adapter), cast to x's dtype."""
        if backend == "reference":
            return self.delta(x)
        if backend != "pallas":
            raise ValueError(f"unknown PEFT backend {backend!r}")
        from repro_torch.kernels.ops import quanta_apply_fused

        y = quanta_apply_fused(x, self.unfrozen())
        if self.frozen is not None:
            y = y - quanta_apply_fused(
                x, self.unfrozen(self.frozen_detached()))
        return y.to(x.dtype)

    # --- on a `model` shard: the whole chain on the whole input, then this
    # rank's columns (column-parallel) or, after the reduction, all of it
    # (row-parallel)
    shardable = True

    def col_view(self, off: int, n: int):
        from repro_torch.core.adapters import ColumnSlice

        return ColumnSlice(self, off, n)

    def row_view(self, off: int, n: int):
        return None

    def apply_cols(self, x: torch.Tensor, w, span,
                   backend: str = "reference") -> torch.Tensor:
        """``x @ w + delta(x)[..., span]``: on a folded adapter over a
        dense ``w`` under ``"pallas"`` one ``quanta_linear`` call, whose
        GEMM reads the chain's ``(rows, d_out)`` output at the span's
        column offset."""
        off, n = span
        if (backend == "pallas" and self.frozen is None
                and not isinstance(w, QuantizedLinear)):
            from repro_torch.kernels.ops import quanta_linear_fused

            return quanta_linear_fused(x, w, self, col=off)
        # the base product first: what a checkpointed layer's backward
        # recomputes depends on the order (tests/test_torch_dryrun.py)
        y = base_matmul(x, w, backend)
        delta = self._delta_on(x, backend)
        if n != delta.shape[-1]:
            delta = delta[..., off:off + n]
        return y + delta

    def apply_rows(self, x: torch.Tensor, w, span, gathered,
                   backend: str = "reference"):
        return base_matmul(x, w, backend), self._delta_on(gathered(),
                                                          backend)

    def merge(self, w: torch.Tensor) -> torch.Tensor:
        """``W = W0' + T_theta`` (paper §6, no inference overhead); for a
        fold-free adapter ``W = W0 + T_theta - S``."""
        return merge(w, self)

    def banked_delta(self, x: torch.Tensor, ids: torch.Tensor,
                     backend: str = "reference") -> torch.Tensor:
        """Per-slot delta of a bank-stacked group (every tensor has a
        leading bank axis).

        ``"reference"``: the gather-then-``delta`` of
        :meth:`Adapter.banked_delta`.  ``"pallas"``: every slot's tensors
        are gathered from the bank with one ``index_select`` a tensor on
        the device ids and cast to x's dtype (no host sync, a fixed number
        of launches, so a decode graph captures it); then, slot by slot,
        each chain runs through the chain kernel on the slot's rows, as
        the single-tenant :meth:`apply` does: ``chain_T(x)``, one launch a
        slot, and for a fold-free group ``chain_T(x) - chain_S(x)``, two.
        """
        if backend != "pallas":
            return super().banked_delta(x, ids, backend)
        from repro_torch.kernels.ops import quanta_apply_fused

        sel = tree_map(lambda leaf: leaf.detach().index_select(0, ids).to(
            x.dtype), self)
        out = []
        for b in range(x.shape[0]):
            row = tree_map(lambda leaf, b=b: leaf[b], sel)
            y = quanta_apply_fused(x[b], row.unfrozen())
            if row.frozen is not None:
                y = y - quanta_apply_fused(x[b], row.unfrozen(row.frozen))
            out.append(y.to(x.dtype))
        return torch.stack(out)


def fold_frozen_copy(w0: torch.Tensor, adapter: QuantaAdapter) -> torch.Tensor:
    """``W0' = W0 - S`` (Eq. 8 -> 9), subtracted in the adapter's
    precision and returned in ``w0``'s dtype."""
    s_mat = adapter.matrix()
    return (w0.to(s_mat.dtype) - s_mat).to(w0.dtype)


def merge(w0_folded: torch.Tensor, adapter: QuantaAdapter) -> torch.Tensor:
    """``W = W0' + T_theta``."""
    t_mat = adapter.matrix()
    return (w0_folded.to(t_mat.dtype) + t_mat).to(w0_folded.dtype)
