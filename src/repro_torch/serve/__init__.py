from repro_torch.serve.adapter_pool import (
    AdapterPool, AdapterStore, RowAllocator,
)
from repro_torch.serve.engine import Request, ServingEngine

__all__ = ["AdapterPool", "AdapterStore", "Request", "RowAllocator",
           "ServingEngine"]
