"""Paged continuous-batching engine: the port of the JAX ``PagedEngine``.

Owns the device side of paged serving and executes the
:class:`~repro_torch.serve.scheduler.Scheduler`'s decisions:

* one **page pool per layer** (``lm.init_paged_cache``), all indexed by
  host-managed block tables (one :class:`PagePool` allocation covers the
  stack);
* **prefix-multicast prefill**: a prompt is matched against the
  :class:`PrefixCache`; matched pages are shared (refcount bump, no
  compute) and only the divergent suffix runs, at its true positions,
  through ``decode_step`` (the chunked-prefill kernel K3).  Cold prompts
  run the dense ``lm.prefill`` and are scattered into pages;
* **chunked prefill** (``prefill_chunk``): a long suffix runs as
  fixed-size chunks, each charged its own pages as the table grows;
* **bucketed prompts**: prompts and suffixes right-pad to shared length
  buckets, with padded positions redirected to the null page;
* **decode page faults**: crossing a page boundary allocates on demand;
  a dry pool first evicts cold prefix chains, then **preempts** the
  youngest request by swapping its pages to host memory (bit-identical
  restore on re-admission);
* **copy-on-write**: a fork shares every page of its parent; the first
  divergent write to a shared page gets a private copy;
* **int8 page pools** (``kv_dtype="int8"``): K/V quantised on the way in
  with a bf16 scale per row and head, dequantised by K3 on the gather
  (``"f32"`` gives bf16 pools, as in the JAX package);
* **speculative decoding** (``spec_k > 0``): a draft proposer
  (:mod:`repro_torch.serve.spec`) runs ahead, one verify step at
  ``s = k + 1`` scores every proposal, each slot commits its longest
  accepted prefix, and the pages only the rejected tail reached go back
  to the pool.

The page pools are updated **in place** — the JAX engine returns new
pools from each jitted step and donates the old buffers so XLA may
reuse them; here the tensors are simply written.  A rejected draft's
K/V stays in its page past the committed length, where ``lengths``
masks it, until a later write replaces it.

Failure behaviour, as in the JAX engine — every detector is an
off-by-default flag, and with both flags off and no armed
:class:`~repro_torch.serve.faults.FaultPlan` every code path is the
plain one:

* admission that cannot proceed returns a **typed**
  :class:`~repro_torch.serve.scheduler.Rejected` (``no-free-slot`` /
  ``watermark`` / ``pool-dry``);
* a lost or corrupted preemption swap blob is detected before the
  scatter and the request is **re-prefilled from its own token stream**
  (prompt + generated tokens: greedy decode makes the replay
  token-identical);
* a mid-decode allocation or COW failure with nothing left to reclaim
  **requeues the slot** (bounded by ``MAX_DEGRADE_REQUEUES``, after
  which the request fails with a typed error);
* with ``kv_guard=True``, page chains are **fingerprinted**
  (:class:`~repro_torch.serve.guard.PageFingerprints`) when they enter
  the prefix tree and verified at every prefix hit: a corrupted chain is
  quarantined (dropped from the tree, its readers requeued for replay);
  swap blobs carry a checksum, and a rejected admission must leave every
  refcount as it found it;
* with ``kernel_fallback=True``, a model step that raises — or returns
  non-finite logits — is retried once on the reference backend
  (``kernels.call_with_fallback``), counted in ``stats()``; a kernel that
  cannot be built, loaded or launched is not retried and raises.

**The retry and the in-place pools.**  The JAX engine donates no pool
when the fallback is armed, so a failed primary leaves its inputs
intact.  Here the primary may have written some layers before it
failed.  That is safe without a snapshot: a step writes exactly the rows
its host inputs name — in every layer, the new tokens' K/V (int8 values
and their scales) at (block table, position) for positions below
``lengths``, and the padded positions into the null page — and the
reference retry runs the same step on the same host inputs, so it
rewrites every one of those rows in each layer before that layer's
attention reads them.  That holds for decode, the verify step (its
rejected rows included), the suffix prefill, and the cold prefill,
whose scatter writes the pools only after the whole prefill ran.  After
a retry the pools equal those of a step run on the reference backend
from the start (``tests/test_torch_chaos.py`` holds this bit for bit).

**Sharded pools** (``num_shards > 1``): the pool is partitioned into
per-shard free lists (``pagepool.py``) and every admission is routed to
one shard — pinned by ``Request.shard`` or balanced to the shard with
the most free pages — where all its fresh pages, COW copies and
watermark accounting live.  A prefix hit is matched against that
shard's **local** page copies; where the cached chain continues on
other shards, the engine allocates local pages and **broadcasts** the
chain's bytes into them (one indexed copy per pool tensor — the paper's
crossbar multicast at pod scale), then registers the copies so every
later consumer on the shard hits locally.  The ``broadcast_*`` counters
account the payload and the per-device fabric bytes under
``mcast_mode`` (``dist.mcast.bytes_model(per_device=True)``: the
unicast / sw_tree / hw hierarchy of ``dist/mcast.py``'s collectives),
and each broadcast leaves an ``mcast.broadcast`` trace instant.  As in
the JAX engine without a mesh, the sharded bookkeeping runs on one
device; ``num_shards=1`` is the unsharded engine.

**Over a mesh** (``mesh=``, a mesh bound by
:func:`repro_torch.launch.mesh.bind` whose only axis of more than one rank
is ``config.mesh_axis``, of ``n`` ranks dividing ``num_shards``): rank
``r`` holds the pages of shards ``[r·S/n, (r+1)·S/n)`` and a null page of
its own, so its pool tensors have ``1 + (S/n)·pages_per_shard`` pages.
The JAX engine instead splits the padded page axis evenly, a cut that
falls inside a shard; aligning to shards keeps a request's fresh pages,
COW copies and broadcast copies on one rank.  Every rank runs the same
host bookkeeping (pool, prefix tree, scheduler, slots; page ids global),
so every decision and the logical ``stats()`` are the same on every rank
and equal the JAX engine's; ids become local only where they reach a
device tensor.  A slot belongs to the rank of its shard:

* a prefill (cold, suffix, chunked) runs on the slot's rank only;
* the decode step runs the whole batch on every rank that holds a slot
  (the one-device engine's M, so each row rounds as there), the other
  ranks' slots pointed at the local null page;
* each step's sampled tokens reach every rank in one all-reduce of
  ``max_slots`` int32s (a prefill's, of one);
* a chain broadcast packs the chain's pages (K, V and, in int8 pools,
  the scales) on the source's rank into one buffer, delivers it with
  ``dist.mcast``'s collective for ``mcast_mode`` from the source's index
  along the axis (3 / 2 / 0 point-to-point rounds at n = 4 for unicast /
  sw_tree / hw; ``broadcast_rounds`` keeps the last chain's), and unpacks
  it into the consumer's pages — also when source and consumer share a
  rank;
* a cross-rank COW copy, a swap-in on another rank than the swap-out,
  and the pages a forked slot reads from another rank (its parent's,
  kept as *mirrors* past the rank's own pages, refreshed before each
  decode step; a mirror a slot writes is sent home after the step) move
  by point-to-point sends.

Every option runs over a mesh by one rule: every rank calls the same
collectives in the same order on every path, the failing ones included,
and a verdict that depends on device bytes is computed on the rank that
holds them and shared in one small all-reduce, so every rank takes the
same host decision from it:

* **speculation**: the verify step runs as the decode step does (mirrors
  refreshed first, the owner's slots carrying a block table, run where the
  rank holds a slot); the owners' ``target`` rows and accept counts reach
  every rank in one all-reduce, every page the ``k + 1`` rows wrote that is
  a mirror goes home, and a rollback drops the mirrors of the pages it
  releases.  An n-gram draft reads only the token history, alike on every
  rank; a model draft runs on every rank and each slot's drafts come from
  its owner's run, shared in one all-reduce before the verify step;
* **the page guard**: a page's fingerprint is recorded and verified on
  the rank that holds the page, and the set of bad pages is shared, so
  every rank quarantines the same chain; an injected corruption flips the
  page on its home rank and in every mirror of it; a swap blob's checksum
  is taken and checked on the rank holding the blob, and its "lost"
  verdict at swap-in is shared;
* **the kernel fallback and fault plans**: every rank consults
  ``kernel.raise`` and ``kernel.nan`` once per model step, also where it
  has no part in the step, so a plan armed alike on every rank fires
  alike; after the step one all-reduce shares whether it raised or gave
  non-finite logits anywhere, and if so every rank that runs the step
  retries it on the reference backend (``n_fallback`` agrees).  A failure
  that is not retried (a kernel that cannot be built or launched, any
  error without ``kernel_fallback``) ends every rank with the same
  :class:`MeshStepFailed` rather than leaving the others waiting in their
  next collective; an injected raise without the fallback fires on every
  rank and raises JAX's ``InjectedFault`` there.

The ``ServeLoop`` over a mesh runs on rank 0 and sends each of its engine
calls to the other ranks, which make the same calls in the same order
(``serve/server.py``: ``EngineDriver``, ``follow``).
"""
from __future__ import annotations

import dataclasses
import functools
import re
from collections import Counter

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.device import DEFAULT, resolve
from repro_torch.dist import mcast
from repro_torch.kernels import KernelUnavailable
from repro_torch.models import lm
from repro_torch.obs import trace
from repro_torch.serve import faults, guard, sampling, spec
from repro_torch.serve.config import ServeConfig, config_from_legacy
from repro_torch.serve.pagepool import PagePool
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import Rejected, Scheduler, pad_to_bucket

# a degraded slot (COW/alloc failure, lost swap, quarantine) re-enters
# the queue this many times before the request is failed with a typed
# error — the bound that turns a persistent fault into a clean rejection
# instead of an admission/preemption livelock
MAX_DEGRADE_REQUEUES = 8

# sentinel: _swap_in found the swap blob missing/corrupt (distinct from
# an admission Rejected — the caller degrades to a replay re-prefill)
_SWAP_LOST = object()


class MeshStepFailed(RuntimeError):
    """A model step of a mesh engine failed on some rank and is not
    retried: raised on every rank of the mesh, naming the step and the
    ranks it failed on (chained to the error on those ranks)."""


@dataclasses.dataclass
class _MeshBlob:
    """A swap blob over a mesh: the packed pages (host bytes) on the rank
    that swapped the slot out, ``None`` on every other rank."""

    holder: int  # the rank index along the mesh axis that holds ``buf``
    buf: torch.Tensor | None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    # pinned pool shard (host-side routing); None = balance to the shard
    # with the most free pages at admission
    shard: int | None = None
    # set when the engine permanently fails the request (typed reason)
    error: str | None = None
    # preemption swap state:
    # (host page data | None, n_pages, length, last_tok, checksum | None)
    _swap: tuple | None = dataclasses.field(default=None, repr=False)
    # degrade-requeue count (quarantine / lost swap / alloc+COW failure);
    # victim preemptions under memory pressure are normal and don't count
    _requeues: int = dataclasses.field(default=0, repr=False)


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: list[int]  # page ids in block-table order (this slot's refs)
    length: int  # valid tokens (prompt + generated context so far)
    last_tok: int
    admit_seq: int
    shard: int = 0  # pool shard this slot allocates from


class PagedEngine:
    """Continuous-batching server over the paged KV subsystem.

    ``params`` must live on ``device`` (default ``cuda``; the CPU runs the
    kernels' plain versions), and so must a model draft's, passed as
    ``draft=(draft_cfg, draft_params)``."""

    def __init__(self, cfg, params, *, config: ServeConfig | None = None,
                 sampler: sampling.Sampler | None = None, draft=None,
                 device: str | torch.device = DEFAULT, mesh=None, **legacy):
        if config is not None and legacy:
            raise TypeError(
                f"pass either config=ServeConfig(...) or legacy keywords, "
                f"not both: {sorted(legacy)}")
        if config is None:
            config = config_from_legacy(legacy)
        self.device = resolve(device)
        if params["embed"]["table"].device != self.device:
            raise ValueError(f"params live on {params['embed']['table'].device}, "
                             f"the engine on {self.device}")
        self.config = config
        self.cfg = cfg
        self.params = params
        self.max_batch = config.max_slots
        self.page_size = page_size = config.page_size
        self.table_width = config.cache_len // page_size
        self.cache_len = config.cache_len
        self.prompt_bucket = config.prompt_bucket
        self.prefill_chunk = config.prefill_chunk
        self.num_shards = config.num_shards
        self.mcast_mode = config.mcast_mode
        num_pages = config.num_pages
        if num_pages is None:
            # the dense fallback's footprint: one full-length cache per
            # batch slot, plus the null page — rounded up so every shard
            # owns an equal page range and can hold one full-length
            # request (an admission allocates on a single shard)
            per_shard = max(-(-self.max_batch * self.table_width // self.num_shards),
                            self.table_width)
            num_pages = 1 + self.num_shards * per_shard
        self.pool = PagePool(num_pages, page_size, num_shards=self.num_shards)
        self.prefix = PrefixCache(self.pool, page_size)
        self.sched = Scheduler(self.pool, self.prefix, watermark=config.watermark)
        # this rank's page axis: the whole pool on one device; over a mesh
        # its shards' pages and a null page of its own
        self.mesh = mesh
        self.mesh_axis = config.mesh_axis
        self.n_ranks, self.rank = 1, 0
        if mesh is not None:
            self._bind_mesh(mesh, config)
        self._shards_per_rank = self.num_shards // self.n_ranks
        self.num_device_pages = 1 + (num_pages - 1) // self.n_ranks
        self.caches = lm.init_paged_cache(cfg, self.num_device_pages, page_size,
                                          config.kv_dtype, device=self.device)
        self.slots: dict[int, _Slot] = {}
        self._admit_seq = 0
        self._requeue: list[Request] = []  # preempted, waiting to swap in
        self.failed: list[Request] = []  # permanently failed (typed error)
        self.rejections: Counter[str] = Counter()
        self.kernel_calls: Counter[str] = Counter()  # per model-step name
        self.n_preempted = 0
        self.n_cow = 0
        self.n_degrade_requeues = 0
        self.sampler = sampler if sampler is not None else \
            sampling.get_sampler(config.sampler)
        # speculative decoding: a draft proposer runs ahead of the target,
        # and ``_step_spec`` verifies its k proposals in one decode step
        self.spec_k = config.spec_k
        self.spec = None
        if config.spec_k:
            self.spec = spec.make_draft(
                config, cfg, draft=draft, max_slots=self.max_batch,
                cache_len=self.cache_len, sampler=self.sampler,
                kernel_calls=self.kernel_calls, device=self.device)
        self.n_spec_rounds = 0
        self.n_spec_drafted = 0
        self.n_spec_accepted = 0
        self.n_spec_rollbacks = 0
        self.n_spec_rollback_pages = 0

        # page-chain broadcast accounting: payload = bytes of the pages
        # delivered (once), fabric = what each participant moves under the
        # configured multicast mode (the per-device bytes_model)
        self.n_broadcast_chains = 0
        self.n_broadcast_pages = 0
        self.broadcast_payload_bytes = 0
        self.broadcast_fabric_bytes = 0.0
        total_bytes = sum(t.numel() * t.element_size() for c in self.caches for t in c)
        self.page_nbytes = total_bytes // self.num_device_pages
        per_device = mcast.bytes_model(1, self.num_shards, per_device=True)
        self._fabric_mult = per_device[self.mcast_mode]
        self._fabric_mult_unicast = per_device["unicast"]
        self.broadcast_rounds = 0  # point-to-point rounds of the last chain broadcast
        # a mesh rank's mirrors of pages homed on other ranks: global id ->
        # local page (past its own), and every rank's mirrored ids (the
        # host bookkeeping every rank keeps alike)
        self._mirror: dict[int, int] = {}
        self._mirror_free: list[int] = []
        self._mirrored: list[set[int]] = [set() for _ in range(self.n_ranks)]

        # degradation: detectors are opt-in flags; the counters below show
        # in stats(), so a degraded-but-alive server is visible
        self.kv_guard = config.kv_guard
        self.kernel_fallback = config.kernel_fallback
        self.fp = guard.PageFingerprints() if self.kv_guard else None
        self.n_fallback = 0
        self.n_swap_dropped = 0
        self.n_quarantined_pages = 0
        # the model steps by dispatch name; verify is the decode math at
        # s = spec_k + 1, under its own name
        self._steps = {"decode": self._decode, "verify": self._decode,
                       "cold_prefill": self._cold_prefill,
                       "suffix_prefill": self._suffix_prefill}

    # -- the mesh ------------------------------------------------------------
    def _bind_mesh(self, mesh, config: ServeConfig) -> None:
        """Check ``mesh`` and this engine's options against each other and
        take this rank's place: its index along the axis, its shards."""
        if not hasattr(mesh, "group"):
            raise TypeError("mesh= takes a bound mesh (repro_torch.launch.mesh.bind)")
        axis = config.mesh_axis
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh axis {axis!r} not in the mesh's axes {mesh.axis_names}")
        n = mesh.shape[axis]
        if mesh.mesh.size != n:
            raise ValueError(f"PagedEngine(mesh=) splits the pool over one axis: {axis!r} has "
                             f"{n} of the mesh's {mesh.mesh.size} ranks ({mesh.shape})")
        if self.num_shards % n:
            raise ValueError(f"{n} ranks along {axis!r} do not divide num_shards="
                             f"{self.num_shards}: each rank holds whole shards")
        if mesh.device_type == "cuda" and self.device.type != "cuda":
            # NCCL carries CUDA tensors only; gloo carries both (its ranks
            # may share one card)
            raise ValueError(f"a mesh on {mesh.device_type} cannot hold an engine on "
                             f"{self.device}")
        self.n_ranks, self.rank = n, mesh.coords[axis]
        self._group = mesh.group(axis)  # None on one rank: the one-rank world
        if self._group is None:
            self._ranks = [mesh.rank]
        else:
            import torch.distributed as dist

            self._ranks = dist.get_process_group_ranks(self._group)
        self._bcast = mcast.make_broadcast_fn(mesh, None, None, self.mcast_mode, axis=axis)

    def _rank_of_shard(self, shard: int) -> int:
        """The rank index holding ``shard`` (0 on one device); a slot
        belongs to its shard's rank."""
        return shard // self._shards_per_rank

    def _rank_of(self, pid: int) -> int:
        """The rank index holding global page ``pid`` (not the null page)."""
        return self._rank_of_shard(self.pool.shard_of(pid))

    def _home_id(self, pid: int) -> int:
        """Global page ``pid``'s index in its own rank's pool tensors."""
        if pid == 0:
            return 0
        return pid - self._rank_of(pid) * self._shards_per_rank * self.pool.pages_per_shard

    def _local(self, pid: int) -> int:
        """Global page ``pid``'s index in this rank's pool tensors: its own
        page, or its mirror."""
        if pid == 0 or self._rank_of(pid) == self.rank:
            return self._home_id(pid)
        return self._mirror[pid]

    def _pack(self, ids: list[int]) -> torch.Tensor:
        """Pages ``ids`` (local) of every pool tensor, laid end to end as
        bytes: (len(ids) · page_nbytes,) uint8."""
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return torch.cat([t.index_select(1, idx).contiguous().view(torch.uint8).reshape(-1)
                          for c in self.caches for t in c])

    def _unpack(self, buf: torch.Tensor, ids: list[int]) -> None:
        """:meth:`_pack`'s bytes into pages ``ids`` (local) of every pool
        tensor."""
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        off = 0
        for c in self.caches:
            for t in c:
                shape = (t.shape[0], len(ids), *t.shape[2:])
                nb = t.element_size() * shape[0] * len(ids) * t[0, 0].numel()
                t.index_copy_(1, idx, buf[off:off + nb].view(t.dtype).view(shape))
                off += nb

    def _move(self, items) -> None:
        """Point-to-point page moves: each item ``(a, src_ids, b, dst_ids)``
        sends pages ``src_ids`` of rank index ``a`` (its local ids) into
        pages ``dst_ids`` of rank ``b`` (``b``'s local ids; read on ``b``
        only).  Same-rank items copy in place; the others go as one buffer
        each, every send and receive of the call posted together."""
        import torch.distributed as dist

        ops, recvs = [], []
        for tag, (a, src, b, dst) in enumerate(items):
            if a == b:
                if a == self.rank:
                    self._unpack(self._pack(src), dst)
            elif self.rank == a:
                ops.append(dist.P2POp(dist.isend, self._pack(src), self._ranks[b],
                                      self._group, tag))
            elif self.rank == b:
                buf = torch.empty(len(dst) * self.page_nbytes, dtype=torch.uint8,
                                  device=self.device)
                ops.append(dist.P2POp(dist.irecv, buf, self._ranks[a], self._group, tag))
                recvs.append((buf, dst))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for buf, dst in recvs:
            self._unpack(buf, dst)

    def _share(self, tokens: np.ndarray) -> np.ndarray:
        """Every rank's int32 ``tokens`` summed over the axis (each entry
        is nonzero on the one rank that sampled it): one all-reduce."""
        import torch.distributed as dist

        t = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)
        dist.all_reduce(t, group=self._group)
        return t.cpu().numpy()

    def _share_rows(self, rows: np.ndarray, mine: list[int]) -> np.ndarray:
        """``rows`` (one row per slot) with each slot's row taken from the
        rank that owns the slot: one all-reduce."""
        own = np.zeros_like(rows, dtype=np.int32)
        own[mine] = rows[mine]
        return self._share(own)

    def _mirror_page(self) -> int:
        """A free local page past this rank's own pages for a mirror; the
        pool tensors grow by one page when none is free."""
        if not self._mirror_free:
            for i, c in enumerate(self.caches):
                self.caches[i] = type(c)(*[torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
                                           for t in c])
            self._mirror_free.append(self.caches[0][0].shape[1] - 1)
        return self._mirror_free.pop()

    def _refresh_mirrors(self) -> None:
        """Make every page a slot reads present on the slot's rank: mirror
        the pages of other ranks that a rank's slots read (a cross-rank
        fork's parent pages) and drop the mirrors no slot reads any more.
        A page is written only while one slot holds it (shared pages are
        copied first), so a mirror stays current while it is read."""
        if self.mesh is None:
            return
        need = [set() for _ in range(self.n_ranks)]
        for st in self.slots.values():
            o = self._rank_of_shard(st.shard)
            need[o].update(p for p in st.pages if self._rank_of(p) != o)
        for pid in [p for p in self._mirror if p not in need[self.rank]]:
            self._mirror_free.append(self._mirror.pop(pid))
        items = []
        for o in range(self.n_ranks):
            for pid in sorted(need[o] - self._mirrored[o]):
                dst = None
                if o == self.rank:
                    dst = self._mirror[pid] = self._mirror_page()
                items.append((self._rank_of(pid), [self._home_id(pid)], o, [dst]))
        self._mirrored = need
        self._move(items)

    # -- host bookkeeping ---------------------------------------------------
    def _free_slot(self) -> int | None:
        for s in range(self.max_batch):
            if s not in self.slots:
                return s
        return None

    def _table_row(self, pages: list[int]) -> np.ndarray:
        """A block-table row of this rank's page ids (global ones on one
        device)."""
        row = np.zeros(self.table_width, np.int32)
        row[: len(pages)] = pages if self.mesh is None else [self._local(p) for p in pages]
        return row

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _pick_shard(self, req: Request) -> int:
        """The pool shard an admission allocates from: the request's pinned
        shard when set, else the shard with the most free pages, ties to
        the lowest index.  Decided from committed pool state only, so the
        async loop and the sync oracle route identically."""
        if req.shard is not None:
            if not 0 <= req.shard < self.num_shards:
                raise ValueError(
                    f"request {req.rid}: pinned shard {req.shard} out of "
                    f"range (num_shards={self.num_shards})")
            return req.shard
        return max(range(self.num_shards), key=lambda s: (self.pool.free_pages_on(s), -s))

    def _deliver(self, src: list[int], dst: list[int]) -> None:
        """Cached pages ``src`` (copies on other shards) into freshly
        allocated pages ``dst``: on one device one indexed copy per pool
        tensor (K, V and, in int8 pools, their scales); over a mesh, per
        source rank (one for a chain prefilled in one place), the pages
        packed into one buffer there, delivered along the axis by the
        ``mcast_mode`` collective from that rank's index, and unpacked on
        the consumer's rank."""
        if self.mesh is None:
            self._copy_pages(src, dst)
            return
        consumer, rounds, i = self._rank_of(dst[0]), 0, 0
        while i < len(src):
            home, j = self._rank_of(src[i]), i
            while j < len(src) and self._rank_of(src[j]) == home:
                j += 1
            if self.rank == home:
                buf = self._pack([self._home_id(p) for p in src[i:j]])
            else:
                buf = torch.empty((j - i) * self.page_nbytes, dtype=torch.uint8,
                                  device=self.device)
            out = self._bcast(buf, source=home)
            rounds += self._bcast.rounds
            if self.rank == consumer:
                self._unpack(out, [self._home_id(p) for p in dst[i:j]])
            i = j
        self.broadcast_rounds = rounds

    def _broadcast_chain(self, src: list[int], dst: list[int]) -> None:
        """Deliver the bytes of cached pages ``src`` (copies on other
        shards) into freshly allocated local pages ``dst``
        (:meth:`_deliver`) and account the traffic under the configured
        ``mcast_mode``."""
        self._deliver(src, dst)
        self.n_broadcast_chains += 1
        self.n_broadcast_pages += len(dst)
        payload = len(dst) * self.page_nbytes
        self.broadcast_payload_bytes += payload
        self.broadcast_fabric_bytes += payload * self._fabric_mult
        rec = trace.active()
        if rec is not None:
            rec.instant("mcast.broadcast", cat="engine", args={
                "pages": len(dst), "payload_bytes": payload,
                "fabric_bytes": payload * self._fabric_mult,
                "unicast_bytes": payload * self._fabric_mult_unicast,
                "mode": self.mcast_mode,
            })

    # -- model steps --------------------------------------------------------
    def _ref_variant(self, name: str):
        """The model step ``name`` under a forced ``reference`` policy —
        the retry target of ``kernels.call_with_fallback``."""
        fn = self._steps[name]

        def ref(*args):
            with kernels.use_policy("reference"):
                return fn(*args)

        return ref

    def _skip(self, name: str) -> None:
        """A model step this mesh rank has no part in: counted (the count
        is the logical one, the same on every rank) and taken through the
        step's fault sites and shared verdict, not run."""
        self._dispatch(name)

    def _dispatch(self, name: str, *args):
        """Run one model step (``decode`` / ``verify`` / ``cold_prefill`` /
        ``suffix_prefill``) through the fault-injection sites and — when
        ``kernel_fallback`` is armed — the retry-once-on-reference path
        with the non-finite-logits check; counted and traced.  Over a mesh
        no ``args`` means this rank has no part in the step
        (:meth:`_dispatch_mesh`)."""
        self.kernel_calls[name] += 1
        rec = trace.active()
        t0 = rec.now() if rec is not None else 0.0
        if self.mesh is not None:
            out, fell_back = self._dispatch_mesh(name, args)
        elif not self.kernel_fallback:
            out, fell_back = self._primary(name, *args), False
        else:
            out, fell_back = kernels.call_with_fallback(
                functools.partial(self._primary, name), self._ref_variant(name), *args,
                check=kernels.all_finite)
        if fell_back:
            self.n_fallback += 1
        if rec is not None and args:
            rec.complete(f"engine.{name}", t0, cat="kernel", args={"fallback": fell_back})
        return out

    def _primary(self, name: str, *args):
        """The model step on its kernels, through the ``kernel.raise`` and
        ``kernel.nan`` sites."""
        if faults.fires("kernel.raise") is not None:
            raise faults.InjectedFault(f"injected kernel fault in {name}")
        out = self._steps[name](*args)
        if faults.fires("kernel.nan") is not None:
            out = torch.full_like(out, float("nan"))
        return out

    def _dispatch_mesh(self, name: str, args: tuple):
        """:meth:`_dispatch` over a mesh: ``(out, fell_back)``, ``out`` None
        on a rank with no part in the step (empty ``args``).

        Every rank takes the sites in :meth:`_primary`'s order, so one plan
        armed on every rank fires alike on each.  After the step one
        all-reduce shares, per rank, whether the step failed beyond a retry
        (then every rank raises :class:`MeshStepFailed`), and whether it
        raised or, under ``kernel_fallback``, gave non-finite logits; then
        every rank that runs the step retries it on the reference backend
        if any rank needs it, as the one-device engine retries the whole
        batch."""
        if faults.fires("kernel.raise") is not None:  # the same hit on every rank
            if not self.kernel_fallback:
                raise faults.InjectedFault(f"injected kernel fault in {name}")
            return self._retry(name, args, f"InjectedFault: injected kernel fault in {name}")
        out, err = None, None
        if args:
            try:
                out = self._steps[name](*args)
            except Exception as e:  # noqa: BLE001 — shared below, raised or retried
                err = e
        fatal = err is not None and (not self.kernel_fallback
                                     or isinstance(err, KernelUnavailable)
                                     or kernels.device_lost())
        raised = err is not None and not fatal
        bad = out is not None and self.kernel_fallback and not kernels.all_finite(out)
        raised, bad = self._agree(name, err if fatal else None, raised, bad)
        if raised:
            return self._retry(name, args, f"{type(err).__name__}: {err}" if err is not None
                               else "raised on another rank")
        if faults.fires("kernel.nan") is not None:
            if out is not None:
                out = torch.full_like(out, float("nan"))
            bad = self.kernel_fallback
        if bad:
            return self._retry(name, args, kernels.NON_FINITE)
        if self.kernel_fallback:
            kernels.count_guarded_call()
        return out, False

    def _agree(self, name: str, fatal: BaseException | None, *flags: bool) -> list[bool]:
        """One all-reduce over the mesh axis: raise :class:`MeshStepFailed`
        on every rank if step ``name`` failed beyond a retry on any rank
        (``fatal`` there); else each of ``flags`` or-ed over the ranks."""
        v = np.zeros(self.n_ranks + len(flags), np.int32)
        v[self.rank] = fatal is not None
        v[self.n_ranks:] = flags
        v = self._share(v)
        failed = [r for r in range(self.n_ranks) if v[r]]
        if failed:
            raise MeshStepFailed(f"model step {name!r} failed on mesh rank(s) {failed} and is "
                                 f"not retried; every rank stops") from fatal
        return [bool(x) for x in v[self.n_ranks:]]

    def _retry(self, name: str, args: tuple, why: str):
        """The step on the reference backend, where this rank runs it; the
        ranks agree that it ran (the one-device engine's unguarded retry
        raises its error: here every rank raises :class:`MeshStepFailed`)."""
        kernels.count_guarded_call(why)
        out, err = None, None
        if args:
            try:
                out = self._ref_variant(name)(*args)
            except Exception as e:  # noqa: BLE001 — shared below
                err = e
        self._agree(f"{name} (reference retry)", err)
        return out, True

    def _cold_prefill(self, toks, li, table_row, length):
        logits, dense = lm.prefill(self.params, self.cfg, toks, logit_index=li)
        lm.prefill_to_pages(dense, self.caches, table_row, length)
        return logits

    def _suffix_prefill(self, toks, li, table, index, length):
        logits, _ = lm.decode_step(self.params, self.cfg, self.caches, toks, index,
                                   block_table=table, lengths=length)
        return logits[:, li:li + 1]

    def _decode(self, toks, index, table, lengths):
        logits, _ = lm.decode_step(self.params, self.cfg, self.caches, toks, index,
                                   block_table=table, lengths=lengths)
        return logits

    # -- admission ----------------------------------------------------------
    def _reject(self, rej: Rejected) -> Rejected:
        self.rejections[rej.reason] += 1
        return rej

    def _admit(self, req: Request) -> bool | Rejected:
        """Admit a queued request: ``True`` on success, a falsy typed
        :class:`Rejected` otherwise."""
        rec = trace.active()
        if rec is None:
            return self._admit_impl(req)
        t0 = rec.now()
        res = self._admit_impl(req)
        rec.complete("engine.admit", t0, cat="engine",
                     args={"rid": req.rid, "ok": res is True})
        return res

    def _admit_impl(self, req: Request) -> bool | Rejected:
        slot = self._free_slot()
        if slot is None:
            return self._reject(Rejected("no-free-slot"))
        if req._swap is not None:
            res = self._swap_in(slot, req)
            if res is not _SWAP_LOST:
                return res
            # the swap blob was dropped or failed its checksum: the KV
            # bytes are gone, but the token stream is not — fall through
            # and re-prefill from prompt + generated tokens
            self.n_swap_dropped += 1
            req._swap = None
            rec = trace.active()
            if rec is not None:
                rec.instant("engine.swap_lost", cat="engine", args={"rid": req.rid})
        replay = bool(req.out)  # a degraded requeue re-prefills its own stream
        tokens = req.prompt + req.out[:-1] if replay else req.prompt
        if len(req.prompt) + req.max_new + 1 > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new exceeds cache_len "
                f"{self.cache_len}")
        ref0 = list(self.pool._ref) if self.kv_guard else None
        shard = self._pick_shard(req)
        # match BEFORE the watermark check: the refs it takes pin the
        # chain against can_admit's prefix eviction; a rejected admission
        # fully unwinds it.  Only this shard's local copies match; the
        # chain's continuation on other shards is a broadcast candidate
        # (refs taken only on commit)
        shared, n_matched = self.prefix.match(tokens, shard)
        remote = self.prefix.remote_continuation(tokens, shard, len(shared))
        if self.kv_guard and (shared or remote):
            bad = self._verify_pages(shared + [pid for _, pid in remote])
            if bad:
                # corruption caught at the sharing point: quarantine the
                # chain (and its poisoned readers) instead of letting it
                # reach — or be broadcast to — this and every later consumer
                self.prefix.unmatch(shared, len(tokens))
                self._quarantine(bad)
                shared, n_matched, remote = [], 0, []
                ref0 = list(self.pool._ref)
        # broadcast pages count as fresh demand: they are allocated on this
        # shard like any other fresh page; only their bytes come over the
        # fabric instead of through a re-prefill
        fresh_needed = self.sched.pages_for(len(tokens) + 1) - len(shared)
        rej = self.sched.check_admission(fresh_needed, shard)
        if rej is not None:
            self.prefix.unmatch(shared, len(tokens))
            self._assert_refs_unchanged(ref0, "rejected admission")
            return self._reject(rej)
        if remote:
            # the owning shard prefilled the chain once; this shard
            # receives its bytes instead of re-running the model over it
            got = self.pool.alloc(len(remote), shard)
            if got is None:  # injected exhaustion after a green check
                self.prefix.unmatch(shared, len(tokens))
                self._assert_refs_unchanged(ref0, "rejected admission")
                return self._reject(Rejected("pool-dry", len(remote)))
            self._broadcast_chain([pid for _, pid in remote], got)
            self.prefix.commit_broadcast([n for n, _ in remote], shard, got)
            if self.kv_guard:
                self.fp.record(self.caches, got, self._held)
            shared = shared + got
            n_matched += len(got) * self.page_size
            # the commit is durable even if the admission later unwinds
            # (the tree keeps the copies): re-baseline the refcount net
            ref0 = list(self.pool._ref) if self.kv_guard else None

        here = self._rank_of_shard(shard) == self.rank  # this rank prefills
        if n_matched == 0:
            # cold prompt: the dense prefill, scattered into pages
            pages = self.pool.alloc(fresh_needed, shard)
            if pages is None:  # injected exhaustion after a green check
                self._assert_refs_unchanged(ref0, "rejected admission")
                return self._reject(Rejected("pool-dry", fresh_needed))
            toks = pad_to_bucket(tokens, self.prompt_bucket)
            logits = self._dispatch(
                "cold_prefill", self._tensor(toks).long(), len(tokens) - 1,
                self._tensor(self._table_row(pages)), len(tokens)) \
                if here else self._skip("cold_prefill")
        else:
            # prefix hit: only the divergent suffix runs, attending to the
            # shared pages, in chunks of ``prefill_chunk`` tokens
            pages = list(shared)
            suffix = tokens[n_matched:]
            chunk = self.prefill_chunk or len(suffix)
            for c0 in range(0, len(suffix), chunk):
                ctoks = suffix[c0: c0 + chunk]
                last_chunk = c0 + chunk >= len(suffix)
                # the final chunk also covers the first decode write
                end = len(tokens) + 1 if last_chunk else n_matched + c0 + len(ctoks)
                need = self.sched.pages_for_range(len(pages) * self.page_size, end)
                if need:
                    got = self.pool.alloc(need, shard)
                    if got is None:  # injected mid-suffix exhaustion
                        fresh_far = [p for p in pages if p not in shared]
                        if fresh_far:
                            self.pool.release(fresh_far)
                        self.prefix.unmatch(shared, len(tokens))
                        self._assert_refs_unchanged(ref0, "rejected admission")
                        return self._reject(Rejected("pool-dry", need))
                    pages.extend(got)
                toks = pad_to_bucket(ctoks, self.prompt_bucket)
                logits = self._dispatch(
                    "suffix_prefill", self._tensor(toks).long(), len(ctoks) - 1,
                    self._tensor(self._table_row(pages))[None],
                    self._tensor([n_matched + c0]),
                    self._tensor(np.asarray([n_matched + c0 + len(ctoks)], np.int32))) \
                    if here else self._skip("suffix_prefill")
        self.prefix.insert(tokens, pages, shard)
        n_tree = len(tokens) // self.page_size
        if self.kv_guard and n_tree:
            self.fp.record(self.caches, pages[:n_tree], self._held)
        f = faults.fires("page.corrupt")
        if f is not None and n_tree:
            # flip bytes in one page of the chain this admission cached:
            # the corruption a later prefix hit must detect
            self._corrupt_page(pages[min(f.page_index, n_tree - 1)])
        if replay:
            last_tok = req.out[-1]
        else:
            last_tok = int(self.sampler.select(logits)[0, -1]) if here else 0
            if self.mesh is not None:  # the owner's token to every rank
                last_tok = int(self._share(np.asarray([last_tok], np.int32))[0])
        self.slots[slot] = _Slot(
            req=req, pages=pages, length=len(tokens), last_tok=last_tok,
            admit_seq=self._admit_seq, shard=shard,
        )
        self._admit_seq += 1
        if not replay:
            req.out.append(self.slots[slot].last_tok)
        return True

    def _assert_refs_unchanged(self, ref0, what: str) -> None:
        """kv_guard regression net: a ``what`` path must leave every
        refcount exactly as found."""
        if ref0 is not None and ref0 != self.pool._ref:
            delta = {pid: (a, b) for pid, (a, b) in enumerate(zip(ref0, self.pool._ref))
                     if a != b}
            raise guard.GuardViolation(
                f"{what} changed page refcounts: {delta} (page: (before, after))")

    def _held(self, pid: int) -> int | None:
        """Global page ``pid``'s index in this rank's pool tensors where
        this rank holds it as its own, else None (the whole pool on one
        device)."""
        if self.mesh is None:
            return pid
        return self._home_id(pid) if self._rank_of(pid) == self.rank else None

    def _verify_pages(self, ids: list[int]) -> list[int]:
        """The pages of ``ids`` whose fingerprint no longer matches: over a
        mesh each rank verifies the pages it holds and one all-reduce
        shares the verdict, so every rank quarantines alike."""
        bad = self.fp.verify(self.caches, ids, self._held)
        if self.mesh is None:
            return bad
        mask = self._share(np.asarray([pid in bad for pid in ids], np.int32))
        return [pid for pid, m in zip(ids, mask) if m]

    def _corrupt_page(self, pid: int) -> None:
        """Injected corruption (``page.corrupt``): add 1 to the first
        element of page ``pid`` of every pool tensor, every layer and kv
        head — the bit-flip stand-in the fingerprint verify must catch.
        Over a mesh, on the page's home rank and in every mirror of it,
        so it reads corrupt wherever a slot reads it."""
        ids = [i for i in (self._held(pid), self._mirror.get(pid)) if i is not None]
        for c in self.caches:
            for t in c:
                for i in ids:
                    t[:, i, 0, 0] += 1

    def _quarantine(self, bad_pages: list[int]) -> None:
        """Drop the corrupted chain from the prefix tree and requeue any
        running slot still reading one of its pages (their replay
        re-prefills from tokens — correct bytes — so only the chain is
        lost, not its consumers)."""
        dropped = self.prefix.drop(bad_pages)
        self.fp.forget(dropped)
        self.n_quarantined_pages += len(dropped)
        rec = trace.active()
        if rec is not None:
            rec.instant("engine.quarantine", cat="engine", args={"pages": len(dropped)})
        poisoned = set(bad_pages)
        for slot, st in list(self.slots.items()):
            if poisoned & set(st.pages):
                self._requeue_degraded(slot, "quarantined page in block table")

    def _requeue_degraded(self, slot: int, why: str) -> None:
        """Degradation path shared by quarantine and alloc/COW failure:
        free the slot's pages and send the request back to the queue as a
        replay (it re-prefills from its own tokens).  Past
        ``MAX_DEGRADE_REQUEUES`` the request fails with a typed error
        instead of cycling forever."""
        st = self.slots.pop(slot)
        self._release(st.pages)
        st.req._swap = None
        st.req._requeues += 1
        if st.req._requeues > MAX_DEGRADE_REQUEUES:
            st.req.error = f"degraded too often ({why})"
            self.failed.append(st.req)
            return
        self.n_degrade_requeues += 1
        self._requeue.append(st.req)

    # -- preemption (swap to host) and resume -------------------------------
    def _preempt(self, slot: int) -> None:
        if self.mesh is not None:
            self._refresh_mirrors()  # a fork not yet decoded reads other ranks' pages
            st = self.slots.pop(slot)
            holder = self._rank_of_shard(st.shard)
            data = _MeshBlob(holder, self._pack([self._local(p) for p in st.pages]).cpu()
                             if holder == self.rank else None)
        else:
            st = self.slots.pop(slot)
            ids = self._tensor(np.asarray(st.pages, np.int64))
            data = [tuple(t[:, ids].cpu() for t in c) for c in self.caches]
        if faults.fires("swap.drop") is not None:
            data = None  # injected loss of the host swap blob
        checksum = self._blob_checksum(data) if self.kv_guard and data is not None else None
        st.req._swap = (data, len(st.pages), st.length, st.last_tok, checksum)
        rec = trace.active()
        if rec is not None:
            rec.instant("engine.preempt", cat="engine",
                        args={"rid": st.req.rid, "pages": len(st.pages), "shard": st.shard})
        self._release(st.pages)
        self._requeue.append(st.req)
        self.n_preempted += 1

    def _swap_in(self, slot: int, req: Request):
        """Restore a preempted request: ``True``, a typed ``Rejected``, or
        the ``_SWAP_LOST`` sentinel when the blob is missing or corrupt
        (the caller degrades to a replay re-prefill)."""
        data, n_pages, length, last_tok, checksum = req._swap
        if data is None:
            return _SWAP_LOST
        if checksum is not None and self._blob_lost(data, checksum):
            return _SWAP_LOST
        shard = self._pick_shard(req)  # swap-in re-routes like any admission
        rej = self.sched.check_admission(n_pages, shard)
        if rej is not None:
            return self._reject(rej)
        pages = self.pool.alloc(n_pages, shard)
        if pages is None:  # injected exhaustion after a green check
            return self._reject(Rejected("pool-dry", n_pages))
        if self.mesh is not None:
            owner = self._rank_of_shard(shard)
            dst = [self._home_id(p) for p in pages]
            if data.holder == owner:
                if owner == self.rank:
                    self._unpack(data.buf.to(self.device), dst)
            else:  # swapped out on another rank: its bytes cross over
                self._send_blob(data, owner, dst)
        else:
            ids = self._tensor(np.asarray(pages, np.int64))
            for c, saved in zip(self.caches, data):
                for t, host in zip(c, saved):
                    t[:, ids] = host.to(self.device)
        req._swap = None
        rec = trace.active()
        if rec is not None:
            rec.instant("engine.swap_in", cat="engine",
                        args={"rid": req.rid, "pages": n_pages, "shard": shard})
        self.slots[slot] = _Slot(req=req, pages=pages, length=length,
                                 last_tok=last_tok, admit_seq=self._admit_seq, shard=shard)
        self._admit_seq += 1
        return True

    def _blob_checksum(self, data) -> int:
        """A swap blob's checksum, over a mesh taken on the rank holding
        the blob (0 elsewhere, never read)."""
        if self.mesh is None:
            return guard.blob_checksum(data)
        return guard.blob_checksum(data.buf) if data.buf is not None else 0

    def _blob_lost(self, data, checksum: int) -> bool:
        """True when a swap blob no longer matches its checksum: over a
        mesh, checked where the blob is held and shared in one
        all-reduce."""
        if self.mesh is None:
            return guard.blob_checksum(data) != checksum
        lost = data.buf is not None and guard.blob_checksum(data.buf) != checksum
        return bool(self._share(np.asarray([lost], np.int32))[0])

    def _send_blob(self, blob: _MeshBlob, owner: int, dst: list[int]) -> None:
        """A swap blob from the rank holding it into pages ``dst`` of rank
        ``owner``: one point-to-point send."""
        import torch.distributed as dist

        if self.rank == blob.holder:
            dist.send(blob.buf.to(self.device), self._ranks[owner], group=self._group)
        elif self.rank == owner:
            buf = torch.empty(len(dst) * self.page_nbytes, dtype=torch.uint8,
                              device=self.device)
            dist.recv(buf, self._ranks[blob.holder], group=self._group)
            self._unpack(buf, dst)

    def _pick_victim(self, exclude: set[int] = frozenset(),
                     shard: int | None = None) -> int | None:
        """Youngest running slot outside ``exclude`` — restricted to
        ``shard``'s slots when given: preempting a slot on another shard
        frees pages the starved allocation cannot use."""
        order = sorted((s for s in self.slots
                        if s not in exclude and (shard is None or self.slots[s].shard == shard)),
                       key=lambda s: self.slots[s].admit_seq)
        return self.sched.pick_victim(order)

    # -- copy-on-write / fork ----------------------------------------------
    def fork(self, slot: int, req: Request, shard: int | None = None) -> int | None:
        """Fork a running request: the child shares *every* page of the
        parent (one refcount bump per page, no copies); the next write to
        the shared tail page copies it.  Returns the child slot.

        ``shard`` routes the child's *future* allocations (page faults,
        COW copies) to another shard — a cross-shard fork keeps reading
        the parent's pages where they are and localises only its
        divergence; the default is the parent's shard (or the request's
        pinned one)."""
        child_slot = self._free_slot()
        if child_slot is None:
            return None
        st = self.slots[slot]
        if shard is None:
            shard = st.shard if req.shard is None else req.shard
        self.pool.share(st.pages)
        self.slots[child_slot] = _Slot(
            req=req, pages=list(st.pages), length=st.length,
            last_tok=st.last_tok, admit_seq=self._admit_seq, shard=shard)
        self._admit_seq += 1
        req.out.extend(st.req.out)
        return child_slot

    def _copy_pages(self, src: list[int], dst: list[int]) -> None:
        """Pages ``src`` -> pages ``dst`` in every layer's pools: one indexed
        copy per pool tensor (K, V and, in int8 pools, their scales); over
        a mesh, from each page's rank to the other's (a point-to-point send
        where they differ)."""
        if self.mesh is not None:
            self._move([(self._rank_of(a), [self._home_id(a)], self._rank_of(b),
                         [self._home_id(b)]) for a, b in zip(src, dst)])
            return
        s, d = self._tensor(np.asarray(src, np.int64)), self._tensor(np.asarray(dst, np.int64))
        for c in self.caches:
            for t in c:
                t.index_copy_(1, d, t.index_select(1, s))

    def _alloc_for_decode(self, n: int, *, exclude: set[int],
                          shard: int = 0) -> list[int] | None:
        """Allocate decode pages on ``shard``, escalating: free list ->
        prefix eviction -> preemption of the youngest same-shard request
        not in ``exclude`` (a slot on another shard is never preempted:
        its pages could not satisfy this shard's demand)."""
        while True:
            if self.sched.reclaim(n, shard):
                got = self.pool.alloc(n, shard)
                if got is not None:
                    return got
                # an armed fault plan can fail the alloc even after a
                # green reclaim — fall through to the escalation below
            victim = self._pick_victim(exclude, shard)
            if victim is None:
                return None
            self._preempt(victim)

    def _ensure_writable(self, slot: int, n: int = 1) -> bool:
        """Before a step writes positions ``length .. length+n-1`` (``n > 1``
        for a speculative verify burst): make sure every covering page
        exists in the slot's table and is exclusively owned (COW).
        Returns False when the slot was requeued instead."""
        st = self.slots[slot]
        last = (st.length + n - 1) // self.page_size
        if last >= self.table_width:
            raise RuntimeError(f"request {st.req.rid} overran cache_len")
        for need in range(st.length // self.page_size, last + 1):
            if need >= len(st.pages):
                got = self._alloc_for_decode(1, exclude={slot}, shard=st.shard)
                if got is None:
                    self._requeue_degraded(slot, "page fault with pool exhausted")
                    return False
                st.pages.extend(got)
            elif self.pool.refcount(st.pages[need]) > 1:
                # the private copy lands on the slot's own shard — a
                # forked child routed cross-shard localises its divergence
                res = self.pool.cow(st.pages[need], st.shard)
                if res is None:  # pool dry: make room, then retry the COW
                    got = self._alloc_for_decode(1, exclude={slot}, shard=st.shard)
                    if got is not None:
                        self.pool.release(got)
                        res = self.pool.cow(st.pages[need], st.shard)
                if res is None:
                    self._requeue_degraded(slot, "COW failure with pool exhausted")
                    return False
                new_id, copied = res
                if copied:
                    self._copy_pages([st.pages[need]], [new_id])
                    self.n_cow += 1
                st.pages[need] = new_id
        return True

    # -- main loop ----------------------------------------------------------
    def step(self) -> list[Request]:
        """One decode step over the active batch; returns finished requests."""
        rec = trace.active()
        if rec is None:
            return self._step_impl()
        t0 = rec.now()
        n_slots = len(self.slots)
        out = self._step_impl()
        rec.complete("engine.step", t0, cat="engine",
                     args={"n_slots": n_slots, "finished": len(out)})
        return out

    def _step_impl(self) -> list[Request]:
        if self.spec is not None and self.slots:
            # the round's draft width: k proposals need k+1 scored
            # positions, and no slot may commit past its max_new — clamp
            # k, and take the plain step when even k = 1 does not fit
            # (the near-finish tail stays the plain run's)
            k = min(self.spec_k,
                    min(st.req.max_new - len(st.req.out) for st in self.slots.values()) - 1)
            if k >= 1:
                return self._step_spec(k)
        for slot in sorted(self.slots, key=lambda s: self.slots[s].admit_seq):
            if slot in self.slots:  # a page fault may preempt later slots
                self._ensure_writable(slot)
        if not self.slots:
            return []
        self._refresh_mirrors()
        toks = np.zeros((self.max_batch, 1), np.int64)
        index = np.zeros(self.max_batch, np.int64)
        lengths = np.zeros(self.max_batch, np.int32)
        table = np.zeros((self.max_batch, self.table_width), np.int32)
        mine = [slot for slot, st in self.slots.items() if self._rank_of_shard(st.shard) == self.rank]
        for slot, st in self.slots.items():
            toks[slot, 0] = st.last_tok
            index[slot] = st.length
            lengths[slot] = st.length + 1
            if slot in mine:  # another rank's slot writes and reads the null page
                table[slot] = self._table_row(st.pages)
        logits = self._dispatch(
            "decode", self._tensor(toks), self._tensor(index), self._tensor(table),
            self._tensor(lengths)) if mine else self._skip("decode")
        if self.mesh is None:
            nxt = self.sampler.select(logits)[:, -1]
        else:
            own = np.zeros(self.max_batch, np.int32)
            if mine:
                own[mine] = np.asarray(self.sampler.select(logits)[:, -1])[mine]
            nxt = self._share(own)
            self._write_back()
        finished = []
        for slot, st in list(self.slots.items()):
            st.length += 1
            st.last_tok = int(nxt[slot])
            st.req.out.append(st.last_tok)
            if len(st.req.out) >= st.req.max_new:
                finished.append(st.req)
                self._release(st.pages)
                del self.slots[slot]
        return finished

    def _write_back(self, n: int = 1) -> None:
        """After a decode (``n = 1``) or verify (``n = k + 1``) step over a
        mesh: every page a slot's ``n`` rows just wrote, where it is a
        mirror (a forked slot's own copy of its parent's pages, exclusively
        held), back to its home rank."""
        items = []
        for st in self.slots.values():
            a = self._rank_of_shard(st.shard)
            for i in range(st.length // self.page_size,
                           (st.length + n - 1) // self.page_size + 1):
                pid = st.pages[i]
                home = self._rank_of(pid)
                if a != home:
                    src = self._mirror[pid] if a == self.rank else None
                    items.append((a, [src], home, [self._home_id(pid)]))
        self._move(items)

    def _release(self, pages: list[int]) -> None:
        """Release a slot's references to ``pages``; over a mesh, drop
        every rank's mirror of a page this frees, so a later reader of the
        page, once reallocated, is sent its new bytes."""
        self.pool.release(pages)
        if self.mesh is None:
            return
        for pid in pages:
            if self.pool.refcount(pid) == 0:
                for mirrored in self._mirrored:
                    mirrored.discard(pid)
                if pid in self._mirror:
                    self._mirror_free.append(self._mirror.pop(pid))

    def _step_spec(self, k: int) -> list[Request]:
        """One speculative verify-accept round: the draft proposes ``k``
        tokens per slot, the target scores all of them and the pending
        token in ONE decode step (K3 at ``s = k + 1``), and each slot
        commits the longest accepted prefix.

        The verify step feeds ``[last_tok, d_1..d_k]`` at ``index =
        length``; scored position ``i`` predicts the token after draft
        ``i``, so the sampler's choice there is what draft ``i+1`` is
        checked against.  A round commits ``c = min(a+1, k, budget)``
        tokens (``a`` accepted): the ``a+1``-th is the one every verify
        step yields for free; capping at ``k`` keeps the draft exactly one
        pending token behind.

        Rollback: rejected drafts wrote real K/V into real pages, in
        place; ``lengths`` masks them, later writes replace them, and any
        page past the committed length is released here — each was made
        exclusively owned by ``_ensure_writable`` (fresh or COW), so the
        release keeps refcounts, prefix chains and ``check()`` exact."""
        for slot in sorted(self.slots, key=lambda s: self.slots[s].admit_seq):
            if slot in self.slots:  # a page fault may preempt later slots
                self._ensure_writable(slot, k + 1)
        if not self.slots:
            return []
        self._refresh_mirrors()
        views = {slot: spec.SlotView(rid=st.req.rid,
                                     tokens=tuple(st.req.prompt) + tuple(st.req.out),
                                     length=st.length)
                 for slot, st in self.slots.items()}
        mine = [slot for slot, st in self.slots.items()
                if self._rank_of_shard(st.shard) == self.rank]
        drafts = np.asarray(self.spec.propose(views, k), np.int32)
        if self.mesh is not None and not isinstance(self.spec, spec.NgramDraft):
            drafts = self._share_rows(drafts, mine)  # each slot's drafts from its owner
        toks = np.zeros((self.max_batch, k + 1), np.int64)
        index = np.zeros(self.max_batch, np.int64)
        lengths = np.zeros(self.max_batch, np.int32)
        table = np.zeros((self.max_batch, self.table_width), np.int32)
        for slot, st in self.slots.items():
            toks[slot, 0] = st.last_tok
            toks[slot, 1:] = drafts[slot]
            index[slot] = st.length
            lengths[slot] = st.length + k + 1
            if slot in mine:  # another rank's slot writes and reads the null page
                table[slot] = self._table_row(st.pages)
        logits = self._dispatch(
            "verify", self._tensor(toks), self._tensor(index),
            self._tensor(table), self._tensor(lengths)) if mine else self._skip("verify")
        if self.mesh is None:
            target = self.sampler.select(logits)  # (max_batch, k + 1)
            accepted = self.sampler.verify(drafts, target)
        else:  # the owners' rows and accept counts to every rank
            both = np.zeros((self.max_batch, k + 2), np.int32)
            if mine:
                both[:, :k + 1] = self.sampler.select(logits)
                both[:, k + 1] = self.sampler.verify(drafts, both[:, :k + 1])
            both = self._share_rows(both, mine)
            target, accepted = both[:, :k + 1], both[:, k + 1]
            self._write_back(k + 1)
        finished = []
        new_lengths: dict[int, int] = {}
        n_accepted = n_committed = n_rollback_pages = 0
        for slot, st in list(self.slots.items()):
            a = int(accepted[slot])
            c = min(a + 1, k, st.req.max_new - len(st.req.out))
            st.req.out.extend(int(t) for t in target[slot, :c])
            st.length += c
            st.last_tok = int(target[slot, c - 1])
            self.n_spec_drafted += k
            self.n_spec_accepted += a
            n_accepted += a
            n_committed += c
            # release the pages only the rejected tail reached
            keep = (st.length - 1) // self.page_size + 1
            if keep < len(st.pages):
                self._release(st.pages[keep:])
                n_rollback_pages += len(st.pages) - keep
                self.n_spec_rollback_pages += len(st.pages) - keep
                del st.pages[keep:]
            if a < k:
                self.n_spec_rollbacks += 1
            if len(st.req.out) >= st.req.max_new:
                finished.append(st.req)
                self._release(st.pages)
                del self.slots[slot]
                self.spec.forget(slot)
            else:
                new_lengths[slot] = st.length
        self.spec.observe(new_lengths)
        self.n_spec_rounds += 1
        rec = trace.active()
        if rec is not None:
            rec.instant("spec.verify", cat="engine", args={
                "k": k, "n_slots": len(views), "drafted": k * len(views),
                "accepted": n_accepted, "committed": n_committed,
                "rollback_pages": n_rollback_pages})
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve ``requests`` to completion; returns them as they finish."""
        queue = list(requests)
        done: list[Request] = []
        stall = 0  # consecutive empty-batch rounds with a rejected head
        while queue or self.slots or self._requeue:
            if self._requeue:  # preempted requests re-enter at the front
                queue = self._requeue + queue
                self._requeue = []
            last_rej: Rejected | bool = True
            while queue:
                last_rej = self._admit(queue[0])
                if not last_rej:
                    break
                queue.pop(0)
            if self.slots:
                stall = 0
                done.extend(self.step())
                continue
            if not queue:
                continue  # degraded requeues merge next round
            # nothing running and the head was rejected: without faults
            # this is deterministic — raise immediately; with a plan armed
            # the rejection may be transient, so retry a bounded number of
            # rounds before declaring the pool undersized
            stall += 1
            if faults.active() is None or stall > 100:
                raise RuntimeError(
                    f"pool too small to admit any queued request "
                    f"(head rejected: {last_rej!r})")
        return done

    # -- auditing ------------------------------------------------------------
    def check(self) -> None:
        """Run the pool auditor with the engine's live holders: every
        running slot's chain plus the prefix tree's own references.
        Raises :class:`repro_torch.serve.guard.GuardViolation` on a leaked
        or dropped reference."""
        holders = [st.pages for st in self.slots.values()]
        holders.append(self.prefix.pages())
        self.pool.check(holders)

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        out = {
            "pool": dataclasses.asdict(self.pool.stats),
            "free_pages": self.pool.free_pages,
            "prefix_pages": len(self.prefix),
            "prefix_hit_tokens": self.prefix.hit_tokens,
            "prefix_miss_tokens": self.prefix.miss_tokens,
            "preempted": self.n_preempted,
            "cow_copies": self.n_cow,
            "rejected": dict(self.rejections),
            "kernel_fallbacks": self.n_fallback,
            "swap_dropped": self.n_swap_dropped,
            "quarantined_pages": self.n_quarantined_pages,
            "degrade_requeues": self.n_degrade_requeues,
            "failed": len(self.failed),
            "num_shards": self.num_shards,
            "broadcast_chains": self.n_broadcast_chains,
            "broadcast_pages": self.n_broadcast_pages,
            "broadcast_payload_bytes": self.broadcast_payload_bytes,
            "broadcast_fabric_bytes": self.broadcast_fabric_bytes,
            "kernel_calls": dict(self.kernel_calls),
            "spec_rounds": self.n_spec_rounds,
            "spec_drafted": self.n_spec_drafted,
            "spec_accepted": self.n_spec_accepted,
            "spec_rollbacks": self.n_spec_rollbacks,
            "spec_rollback_pages": self.n_spec_rollback_pages,
            "accept_rate": self.n_spec_accepted / max(1, self.n_spec_drafted),
        }
        for s in range(self.num_shards):
            out[f"shard{s}_free_pages"] = self.pool.free_pages_on(s)
            out[f"shard{s}_in_use"] = self.pool.pages_per_shard - self.pool.free_pages_on(s)
        return out

    # stats() keys that are point-in-time gauges, not cumulative counters:
    # stats_delta reports their current value rather than a difference
    _STAT_GAUGES = frozenset(
        {"free_pages", "prefix_pages", "peak_in_use", "num_shards", "accept_rate"})
    # every per-shard stat is a point-in-time occupancy gauge
    _SHARD_GAUGE_RE = re.compile(r"shard\d+_")

    def _is_gauge(self, key: str) -> bool:
        k = key.removeprefix("pool_")
        return k in self._STAT_GAUGES or self._SHARD_GAUGE_RE.match(k) is not None

    def flat_stats(self) -> dict:
        """:meth:`stats` with the nesting removed: ``pool`` counters as
        ``pool_*`` keys, per-reason rejections as ``rejected_<reason>``,
        per-step dispatches as ``kernel_calls_<step>`` — the shape
        :mod:`repro_torch.serve.metrics` merges into its flat snapshot."""
        flat: dict = {}
        for key, val in self.stats().items():
            if key in ("pool", "rejected", "kernel_calls"):
                flat.update({f"{key}_{k}": v for k, v in val.items()})
            else:
                flat[key] = val
        return flat

    def stats_delta(self) -> dict:
        """Flat dict of counter *deltas* since the previous
        ``stats_delta`` call (first call: since engine construction).
        Gauges (``free_pages``, ``prefix_pages``, ``pool_peak_in_use``,
        ``num_shards``, ``accept_rate`` and the per-shard ``shard{s}_*``
        occupancy family) report their current value."""
        flat = self.flat_stats()
        prev = getattr(self, "_stats_prev", {})
        self._stats_prev = flat
        return {k: v if self._is_gauge(k) else v - prev.get(k, 0) for k, v in flat.items()}
