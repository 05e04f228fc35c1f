"""Paged-KV serving subsystem of the port: prefix-multicast KV sharing.

``config``    — the typed :class:`ServeConfig` (validated dataclass; the
                launcher's flags derive from it),
``pagepool``  — refcounted page allocator (free list, COW, stats),
``prefix``    — radix-tree prefix cache mapping token prefixes to shared
                page chains (LRU eviction),
``scheduler`` — admission / reclamation / preemption policy,
``engine``    — the paged continuous-batching engine tying them to the
                model layer and the paged-attention kernels,
``sampling``  — the typed token-selection interface,
``faults``    — deterministic fault-injection plans (the pool and
                scheduler hooks),
``guard``     — the pool invariant auditor.
"""
from repro_torch.serve.config import ServeConfig, add_serve_args  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    MAX_DEGRADE_REQUEUES,
    PagedEngine,
    Request,
    bucket_len,
    pad_to_bucket,
)
from repro_torch.serve.guard import GuardViolation, check_pool  # noqa: F401
from repro_torch.serve.pagepool import NULL_PAGE, PagePool, PoolStats  # noqa: F401
from repro_torch.serve.prefix import PrefixCache  # noqa: F401
from repro_torch.serve.sampling import SAMPLERS, GreedySampler, Sampler, get_sampler  # noqa: F401
from repro_torch.serve.scheduler import Rejected, Scheduler  # noqa: F401
