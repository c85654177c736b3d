"""Serving runtime of the port: the continuous-batching engine (dense or
paged KV cache, one device or a mesh; the decode tick a captured CUDA
graph on the card) over merged, adapter-attached or multi-tenant models (an
``AdapterBank``, or hot-swapped tenants through ``AdapterStore`` +
``AdapterPool``), and the SLA-scheduled, double-buffered streaming front
end (``ServeFrontend``) over it."""

from repro_torch.serve.adapter_pool import (
    AdapterPool, AdapterStore, RowAllocator,
)
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.frontend import ServeFrontend, TokenStream
from repro_torch.serve.paging import (
    BlockAllocator, PagedCacheView, addressable_nbytes,
)
from repro_torch.serve.scheduler import (
    DEFAULT_CLASSES,
    InterleavePolicy,
    LatencyHistogram,
    SLAClass,
    SLAScheduler,
    VirtualClock,
    poisson_arrivals,
)

__all__ = [
    "AdapterPool", "AdapterStore", "BlockAllocator", "DEFAULT_CLASSES",
    "InterleavePolicy", "LatencyHistogram", "PagedCacheView", "Request",
    "RowAllocator", "SLAClass", "SLAScheduler", "ServeFrontend",
    "ServingEngine", "TokenStream", "VirtualClock", "addressable_nbytes",
    "poisson_arrivals",
]
