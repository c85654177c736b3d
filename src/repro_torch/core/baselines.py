"""Baseline PEFT methods the paper compares against (port of
``repro/core/baselines.py``).

Every weight-level adapter implements the ``core.adapters.Adapter``
protocol, so ``core.peft`` and the serving bank (``core.bank``) treat them
uniformly:

* :class:`LoraAdapter` -- Hu et al. 2022 (``dW = B A``, rank r); its
  bank-stacked form routes ``banked_delta`` / ``banked_linear`` to the
  banked-gather kernel (``kernels/banked_gather.py``)
* :class:`DoraAdapter` -- Liu et al. 2024 (magnitude/direction split)
* :class:`DotaAdapter` -- DoRA's split with a tensor-train delta
* :class:`KronaAdapter` -- Edalati et al. 2022 (``dW = A (x) B``)
* :class:`BottleneckAdapter` -- series/parallel bottleneck adapter
  (block-level, not mergeable)

``create`` draws from an explicit ``torch.Generator`` (the JAX package's
keys give other numbers from the same seed; tests carry weights over as
numpy instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from repro_torch.core.adapters import Adapter
from repro_torch.core.quantize import ensure_dense

__all__ = [
    "LoraAdapter",
    "DoraAdapter",
    "DotaAdapter",
    "KronaAdapter",
    "BottleneckAdapter",
]


def _randn(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Gaussian draws from ``gen``, on ``device`` (default: ``gen``'s)."""
    device = gen.device if device is None else device
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class LoraAdapter(Adapter):
    """LoRA: ``y = x @ W0 + (alpha/r) * (x @ A) @ B``.

    ``A (d_in, r)`` Gaussian, ``B (r, d_out)`` zero, so the update starts
    at zero.
    """

    a: torch.Tensor
    b: torch.Tensor
    alpha: float

    @staticmethod
    def create(gen: torch.Generator, d_in: int, d_out: int, *, rank: int,
               alpha: float = 16.0, dtype=torch.float32,
               device=None) -> "LoraAdapter":
        a = _randn(gen, (d_in, rank), dtype, device) / math.sqrt(d_in)
        b = torch.zeros((rank, d_out), dtype=dtype, device=a.device)
        return LoraAdapter(a, b, float(alpha))

    @property
    def rank(self) -> int:
        # last axis, so bank-stacked leaves ((G+1, d_in, r)) agree
        return self.a.shape[-1]

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def delta(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.a.dtype)
        return (self.scale * ((h @ self.a) @ self.b)).to(x.dtype)

    def matrix(self) -> torch.Tensor:
        return self.scale * (self.a @ self.b)

    # --- on a `model` shard: B's columns, or A's rows inside the partial
    # sum ((x_r @ A_r) @ B summed over the ranks is (x @ A) @ B)
    shardable = True

    def col_view(self, off: int, n: int) -> "LoraAdapter":
        return LoraAdapter(self.a, self.b[..., off:off + n], self.alpha)

    def row_view(self, off: int, n: int) -> "LoraAdapter":
        return LoraAdapter(self.a[..., off:off + n, :], self.b, self.alpha)

    # --- banked application: the banked-gather kernel -----------------
    # The CUDA kernel tiles K, so unlike the JAX package there is no VMEM
    # gate: the kernel backend takes it at every shape.

    def banked_delta(self, x: torch.Tensor, ids: torch.Tensor,
                     backend: str = "reference") -> torch.Tensor:
        if backend == "pallas":
            from repro_torch.kernels.banked_gather import banked_lora_delta

            return banked_lora_delta(x, self.a, self.b, ids,
                                     scale=self.scale)
        return super().banked_delta(x, ids, backend)

    def banked_linear(self, x: torch.Tensor, w, ids: torch.Tensor,
                      backend: str = "reference"):
        if (backend == "pallas" and isinstance(w, torch.Tensor)
                and w.dim() == 2):
            from repro_torch.kernels.banked_gather import banked_lora_linear

            return banked_lora_linear(x, w, self.a, self.b, ids,
                                      scale=self.scale)
        return None


def _col_rescale(w: torch.Tensor, m: torch.Tensor,
                 dtype) -> torch.Tensor:
    """``m * w / ||w||_col`` (norms floored at 1e-12), cast to ``dtype``."""
    col_norm = torch.linalg.vector_norm(w, dim=0, keepdim=True)
    return (m[None, :] * w / torch.clamp(col_norm, min=1e-12)).to(dtype)


@dataclasses.dataclass(frozen=True)
class DoraAdapter(Adapter):
    """DoRA: ``W' = m * (W0 + dW_lora) / ||W0 + dW_lora||_col``.

    Weight-coupled (``delta_form = False``): ``apply(x, w0)`` runs against
    the adapted weight, and ``neutral`` needs ``w0``'s column norms; ``m``
    starts at them, so the layer starts at the base model.
    """

    delta_form = False

    a: torch.Tensor
    b: torch.Tensor
    m: torch.Tensor
    alpha: float

    @staticmethod
    def create(gen: torch.Generator, w0: torch.Tensor, *, rank: int,
               alpha: float = 16.0, dtype=torch.float32,
               device=None) -> "DoraAdapter":
        d_in, d_out = w0.shape
        a = _randn(gen, (d_in, rank), dtype, device) / math.sqrt(d_in)
        b = torch.zeros((rank, d_out), dtype=dtype, device=a.device)
        m = torch.linalg.vector_norm(w0.to(dtype), dim=0)
        return DoraAdapter(a, b, m.to(a.device), float(alpha))

    def adapted_weight(self, w0) -> torch.Tensor:
        # the column-norm rescale reads the whole matrix: a quantized
        # frozen base is materialized
        w0 = ensure_dense(w0)
        w = w0.to(self.a.dtype) + (self.alpha / self.a.shape[1]) * (
            self.a @ self.b)
        return _col_rescale(w, self.m, w0.dtype)

    def apply(self, x: torch.Tensor, w0,
              backend: str = "reference") -> torch.Tensor:
        del backend
        return x @ self.adapted_weight(w0)

    def merge(self, w0) -> torch.Tensor:
        return self.adapted_weight(w0)

    def neutral(self, w0) -> "DoraAdapter":
        """Zero low-rank factors and ``m`` = column norms of ``w0``."""
        w0 = ensure_dense(w0)
        return DoraAdapter(
            torch.zeros_like(self.a), torch.zeros_like(self.b),
            torch.linalg.vector_norm(w0.to(self.a.dtype), dim=0),
            self.alpha,
        )


@dataclasses.dataclass(frozen=True)
class DotaAdapter(Adapter):
    """DoTA: DoRA's magnitude/direction split with a tensor-train delta::

        W' = m * (W0 + dW_tt) / ||W0 + dW_tt||_col
        dW_tt[i, j] = G_1[i_1, j_1] G_2[i_2, j_2] ... G_N[i_N, j_N]

    Each core ``G_k`` is ``(r_{k-1}, f_in_k, f_out_k, r_k)`` with bond
    ranks ``r_0 = r_N = 1``; the last core starts at zero and ``m`` at
    ``W0``'s column norms.  Weight-coupled, like DoRA.
    """

    delta_form = False

    cores: Tuple[torch.Tensor, ...]
    m: torch.Tensor
    dims_in: Tuple[int, ...]
    dims_out: Tuple[int, ...]

    @staticmethod
    def create(gen: torch.Generator, w0: torch.Tensor, *, rank: int = 2,
               n_axes: int = 3, dims_in: Sequence[int] | None = None,
               dims_out: Sequence[int] | None = None, dtype=torch.float32,
               device=None) -> "DotaAdapter":
        d_in, d_out = w0.shape
        if dims_in is None or dims_out is None:
            # QuanTA's axis factorization; deferred: peft imports this
            from repro_torch.core.peft import choose_dims

            dims_in, dims_out = choose_dims(d_in, d_out, n_axes)
        dims_in, dims_out = tuple(dims_in), tuple(dims_out)
        if math.prod(dims_in) != d_in or math.prod(dims_out) != d_out:
            raise ValueError(
                f"dims {dims_in}x{dims_out} do not factor ({d_in}, {d_out})")
        n = len(dims_in)
        ranks = (1,) + (rank,) * (n - 1) + (1,)
        cores = []
        for k in range(n):
            shape = (ranks[k], dims_in[k], dims_out[k], ranks[k + 1])
            core = _randn(gen, shape, dtype, device)
            # the last core starts at zero: a zero update at init
            cores.append(core.zero_() if k == n - 1
                         else core / math.sqrt(ranks[k] * dims_in[k]))
        m = torch.linalg.vector_norm(w0.to(dtype), dim=0)
        return DotaAdapter(tuple(cores), m.to(cores[0].device), dims_in,
                           dims_out)

    def tt_matrix(self) -> torch.Tensor:
        """The tensor-train delta as ``(d_in, d_out)``."""
        mat = torch.ones((1, 1, 1), dtype=self.cores[0].dtype,
                         device=self.cores[0].device)
        for core in self.cores:
            # (I, O, r) x (r, a, b, s) -> (I*a, O*b, s)
            mat = torch.einsum("ior,rabs->iaobs", mat, core)
            i, a, o, b, s = mat.shape
            mat = mat.reshape(i * a, o * b, s)
        return mat[:, :, 0]

    def adapted_weight(self, w0) -> torch.Tensor:
        w0 = ensure_dense(w0)
        w = w0.to(self.m.dtype) + self.tt_matrix()
        return _col_rescale(w, self.m, w0.dtype)

    def apply(self, x: torch.Tensor, w0,
              backend: str = "reference") -> torch.Tensor:
        del backend
        return x @ self.adapted_weight(w0)

    def merge(self, w0) -> torch.Tensor:
        return self.adapted_weight(w0)

    def neutral(self, w0) -> "DotaAdapter":
        """Zero cores and ``m`` = column norms of ``w0``."""
        w0 = ensure_dense(w0)
        return DotaAdapter(
            tuple(torch.zeros_like(c) for c in self.cores),
            torch.linalg.vector_norm(w0.to(self.m.dtype), dim=0),
            self.dims_in, self.dims_out,
        )


@dataclasses.dataclass(frozen=True)
class KronaAdapter(Adapter):
    """KronA: ``dW = s * (A (x) B)`` with ``A (a_in, a_out)``, ``B (b_in,
    b_out)``, ``a_in * b_in = d_in``, ``a_out * b_out = d_out``."""

    a: torch.Tensor
    b: torch.Tensor
    scale: float

    @staticmethod
    def create(gen: torch.Generator, d_in: int, d_out: int, *, a_in: int,
               a_out: int | None = None, scale: float = 1.0,
               dtype=torch.float32, device=None) -> "KronaAdapter":
        a_out = a_out if a_out is not None else a_in
        if d_in % a_in or d_out % a_out:
            raise ValueError(
                f"KronA factors must divide: {d_in}%{a_in}, {d_out}%{a_out}")
        b_in, b_out = d_in // a_in, d_out // a_out
        a = _randn(gen, (a_in, a_out), dtype, device) / math.sqrt(a_in)
        b = torch.zeros((b_in, b_out), dtype=dtype, device=a.device)
        return KronaAdapter(a, b, float(scale))

    def delta(self, x: torch.Tensor) -> torch.Tensor:
        a_in, a_out = self.a.shape
        b_in, b_out = self.b.shape
        h = x.to(self.a.dtype)
        batch = h.shape[:-1]
        h = h.reshape(*batch, a_in, b_in)
        # (x reshaped (a_in, b_in)) -> A^T x B : (a_out, b_out)
        y = torch.einsum("...ab,ac,bd->...cd", h, self.a, self.b)
        return (self.scale * y.reshape(*batch, a_out * b_out)).to(x.dtype)

    def matrix(self) -> torch.Tensor:
        return self.scale * torch.kron(self.a, self.b)


@dataclasses.dataclass(frozen=True)
class BottleneckAdapter:
    """Series / parallel bottleneck adapter (Houlsby et al.; He et al.):
    ``h + up(relu(down(h)))``.  Not mergeable into the base weights."""

    down: torch.Tensor
    up: torch.Tensor
    bias_down: torch.Tensor
    bias_up: torch.Tensor

    @staticmethod
    def create(gen: torch.Generator, d: int, *, bottleneck: int,
               dtype=torch.float32, device=None) -> "BottleneckAdapter":
        down = _randn(gen, (d, bottleneck), dtype, device) / math.sqrt(d)
        up = torch.zeros((bottleneck, d), dtype=dtype, device=down.device)
        return BottleneckAdapter(
            down, up, torch.zeros_like(down[0]), torch.zeros_like(up[0]))

    @property
    def num_params(self) -> int:
        return sum(t.numel() for t in (self.down, self.up, self.bias_down,
                                       self.bias_up))

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        z = torch.relu(h.to(self.down.dtype) @ self.down + self.bias_down)
        return h + (z @ self.up + self.bias_up).to(h.dtype)
