"""QuanTA core of the port: factorization, the adapter protocol, the
QuanTA operator, the PEFT attachment layer and the rank tools of the
paper's analysis (``core/analysis.py``)."""

from repro_torch.core.adapters import Adapter, base_matmul
from repro_torch.core.analysis import (
    effective_rank, operator_rank, rank_bounds, similarity_grid,
    subspace_similarity,
)
from repro_torch.core.factorize import (
    factorize, pair_schedule, param_count, parse_scheme,
)
from repro_torch.core.peft import (
    AdapterSet, PeftConfig, attach, merge_all, peft_linear,
)
from repro_torch.core.quanta import (
    QuantaAdapter, apply_einsum, apply_sequential, fold_frozen_copy,
    materialize, merge,
)

__all__ = [
    "Adapter", "base_matmul", "factorize", "pair_schedule", "param_count",
    "parse_scheme", "AdapterSet", "PeftConfig", "attach", "merge_all",
    "peft_linear", "QuantaAdapter", "apply_einsum", "apply_sequential",
    "fold_frozen_copy", "materialize", "merge", "effective_rank",
    "operator_rank", "rank_bounds", "similarity_grid", "subspace_similarity",
]
