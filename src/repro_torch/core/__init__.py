"""QuanTA core of the port: factorization, the adapter protocol, the
QuanTA operator and the PEFT attachment layer."""

from repro_torch.core.adapters import Adapter, base_matmul
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
    "fold_frozen_copy", "materialize", "merge",
]
