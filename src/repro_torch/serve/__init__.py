"""Paged-KV serving subsystem of the port: prefix-multicast KV sharing.

``config``    — the typed :class:`ServeConfig` (validated dataclass; the
                launcher's flags derive from it),
``pagepool``  — refcounted page allocator (free list, COW, stats),
``prefix``    — radix-tree prefix cache mapping token prefixes to shared
                page chains (LRU eviction),
``scheduler`` — admission / reclamation / preemption policy,
``engine``    — the paged continuous-batching engine tying them to the
                model layer and the paged-attention kernels,
``server``    — the async continuous-batching serve loop: streaming
                request lifecycle, background prefill/decode/emit
                workers, typed admission backpressure, clean drain; its
                engine calls as one command order, followed by every
                rank of a mesh,
``metrics``   — streaming latency histograms + the flat, schema-checked
                metrics snapshot,
``sampling``  — the typed token-selection interface (``Sampler``):
                one decision point for admission, decode, and the
                speculative verify-accept rule composed over it,
``spec``      — speculative-decoding draft proposers (``ModelDraft``
                registry pairings, ``NgramDraft`` prompt-lookup) feeding
                the engine's one-dispatch verify step,
``loadgen``   — seeded Poisson arrival traces (the reproducible load
                workload; the JAX package's draws),
``faults``    — deterministic fault-injection plans for chaos testing,
``guard``     — pool invariant auditor + per-page content fingerprints.
"""
from repro_torch.serve.config import (  # noqa: F401
    ServeConfig,
    add_serve_args,
    config_from_legacy,
    parse_chaos,
)
from repro_torch.serve.engine import (  # noqa: F401
    MAX_DEGRADE_REQUEUES,
    MeshStepFailed,
    PagedEngine,
    Request,
)
from repro_torch.serve.faults import Fault, FaultPlan, InjectedFault  # noqa: F401
from repro_torch.serve.guard import (  # noqa: F401
    GuardViolation,
    PageFingerprints,
    blob_checksum,
    check_pool,
    page_checksums,
)
from repro_torch.serve.loadgen import Arrival, LoadGen  # noqa: F401
from repro_torch.serve.metrics import (  # noqa: F401
    SNAPSHOT_SCHEMA,
    ServeMetrics,
    StreamingHistogram,
    validate_snapshot,
)
from repro_torch.serve.pagepool import NULL_PAGE, PagePool, PoolStats  # noqa: F401
from repro_torch.serve.prefix import PrefixCache  # noqa: F401
from repro_torch.serve.sampling import SAMPLERS, GreedySampler, Sampler, get_sampler  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    Rejected,
    Scheduler,
    bucket_len,
    pad_to_bucket,
)
from repro_torch.serve.server import (  # noqa: F401
    EngineDriver,
    Lifecycle,
    ServedRequest,
    ServeLoop,
    TokenStream,
    follow,
    replay,
)
from repro_torch.serve.spec import (  # noqa: F401
    DraftModel,
    ModelDraft,
    NgramDraft,
    SlotView,
    make_draft,
)
